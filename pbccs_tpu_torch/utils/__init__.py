"""Shared host-side utilities of the port (a copy of the parts of
pbccs_tpu.utils it needs)."""


def next_pow2(n: int, lo: int = 8) -> int:
    """Smallest power of two >= n, at least `lo` (the serial scorer's
    padding buckets)."""
    v = lo
    while v < n:
        v *= 2
    return v
