"""Milliseconds a refine round leaves the card idle: the time inside
each `polish.round` span's profiler range (the host timeline, on the
kernels' clock; the round's fetches, the next pass's live count
included) that no CUDA kernel covers, summed over the rounds, over
their number."""

import bisect

import devtrace


def read(r):
    rounds = [(s, e) for n, s, e in r.host if n == "polish.round"]
    if not rounds or not r.kernels:
        return None
    ks = sorted((s, e) for _, s, e in r.kernels)
    starts = [s for s, _ in ks]
    longest = max(e - s for s, e in ks)
    idle = 0.0
    for s, e in rounds:
        lo = bisect.bisect_left(starts, s - longest)
        hi = bisect.bisect_left(starts, e)
        busy = devtrace.union_us((max(a, s), min(b, e))
                                 for a, b in ks[lo:hi] if b > s)
        idle += (e - s) - busy
    return idle / 1e3 / len(rounds)
