"""The least time the card could take for a kernel launch: a frozen copy
of the port's roofline arithmetic (pbccs_tpu_torch/obs/roofline.py:
k1_work, k3_work, bound_seconds and their constants), so that the
yardstick does not move with the program.

Peaks are the NVIDIA H100 SXM data sheet's at its 700 W power limit:
3.35 TB/s of HBM, 132 SMs at a 1.98 GHz boost clock, and per clock and
SM 128 float32 results (the kernels build with -fmad=false, so each add
or multiply is one instruction) and 64 32-bit integer results (CUDA C++
Programming Guide, compute capability 9.0)."""

from __future__ import annotations

import math

PEAK_BYTES = 3.35e12
H100_SMS = 132
SM_CLOCK_HZ = 1.98e9
F32_OPS_PER_CLOCK = 128
INT_OPS_PER_CLOCK = 64
SM_CLOCKS = H100_SMS * SM_CLOCK_HZ
RATE_F32_OP = F32_OPS_PER_CLOCK * SM_CLOCKS
RATE_INT_OP = INT_OPS_PER_CLOCK * SM_CLOCKS
#: integer, compare, select and logic operations per lane and column of
#: K1 (csrc/arrow_fill.cu), forward and backward
K1_INT_OPS = {False: 31, True: 34}
#: the same per lane and scored position of K3 (csrc/dense_score.cu)
K3_INT_OPS = 12 + 10 + 61 + 80 + 29 + 36
#: template positions per K3 block
K3_BLOCK = 64


def _scan_steps(width: int) -> int:
    return math.ceil(math.log2(width))


def k1_work(R, Imax, Jmax, W: int, dirs=(False, True)):
    """(bytes, integer ops, float32 ops) of K1 over R reads of Imax read
    and Jmax template columns at band width W in directions `dirs`: each
    input read once, each output written once, per lane of every column
    K1_INT_OPS and 6 + 3 ceil(log2 W) float32 operations.  Works on
    numpy arrays elementwise."""
    nc = Jmax + 1
    n_bytes = (R * Imax + R * Jmax + 16 * R * Jmax + 4 * (2 * R + R * nc)
               + 4 * len(dirs) * (R * nc * W + R * nc))
    cells = R * nc * W
    n_int = cells * sum(K1_INT_OPS[d] for d in dirs)
    n_f32 = cells * len(dirs) * (6 + 3 * _scan_steps(W))
    return n_bytes, n_int, n_f32


def k3_work(R: int, nc: int, Imax: int, Jm: int, W: int,
            positions: int | None = None, blocks: int | None = None):
    """(bytes, integer ops, float32 ops) of K3 over `positions` scored
    (read, position) cells in `blocks` live (read, 64-position) blocks
    (default all R x Jm in all blocks)."""
    NB = -(-Jm // K3_BLOCK)
    n = R * Jm if positions is None else positions
    blocks = R * NB if blocks is None else blocks
    n_bytes = (4 * (2 * W * min(n + 2 * blocks, R * nc) + R * nc
                    + 2 * R * (nc + 1) + 2 * R + R * NB + 9 * R * Jm)
               + R * Imax + R * Jm + 16 * R * Jm + 128 * R)
    n_int = n * W * K3_INT_OPS
    n_f32 = n * W * (71 + 42 * _scan_steps(W))
    return n_bytes, n_int, n_f32


def bound_seconds(n_bytes: float, n_int: float, n_f32: float):
    """(least seconds, "bytes" or "operations"): bytes at PEAK_BYTES
    against the operations, whose integer and float32 pipes issue side
    by side."""
    t_b = n_bytes / PEAK_BYTES
    t_o = max(n_int / RATE_INT_OP, n_f32 / RATE_F32_OP)
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
