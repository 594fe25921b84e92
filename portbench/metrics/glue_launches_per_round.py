"""CUDA kernel launches other than K1 and K3 (the torch glue of the
slot geometry, edge programs and splices) per refine round."""

import devtrace


def read(r):
    rounds = r.rounds()
    if not rounds or not r.kernels:
        return None
    glue = sum(1 for n, _, _ in r.kernels
               if not devtrace.kernel_is(n, devtrace.K1_KERNEL)
               and not devtrace.kernel_is(n, devtrace.K3_KERNEL))
    return glue / rounds
