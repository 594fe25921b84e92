"""Share of the traced window in which no CUDA kernel ran, in %."""


def read(r):
    if not r.kernels or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
