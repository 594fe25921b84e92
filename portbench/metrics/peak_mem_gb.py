"""Peak device memory the program allocated over the window
(torch.cuda.max_memory_allocated after reset_peak_memory_stats), GB."""


def read(r):
    return r.peak_bytes / 1e9 if r.peak_bytes else None
