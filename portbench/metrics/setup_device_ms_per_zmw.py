"""Device milliseconds of the batch setup (K1's fills and the read gate)
per ZMW it set up: the card's busy time, the union of its kernels, from
the start of each `polish.setup` profiler range to the end of the
`polish.gates` range after it, whose fetch of the AddRead statistics
waits for the setup's last work; summed, over the `zmws` of the
`polish.setup` spans.  The card is idle when a setup opens (the batch
before it ended on a fetch), so every kernel in that stretch is the
setup's."""

import bisect

import devtrace


def read(r):
    setups = sorted((s, e) for n, s, e in r.host if n == "polish.setup")
    gates = sorted((s, e) for n, s, e in r.host if n == "polish.gates")
    zmws = sum(a.get("zmws", 0) for n, _, a in r.spans
               if n == "polish.setup")
    if not setups or not gates or not r.kernels or not zmws:
        return None
    starts = [s for s, _ in gates]
    busy = 0.0
    for s, e in setups:
        k = bisect.bisect_left(starts, e)
        if k == len(gates):
            return None
        end = gates[k][1]
        busy += devtrace.union_us((max(a, s), min(b, end))
                                  for _, a, b in r.kernels
                                  if b > s and a < end)
    return busy / 1e3 / zmws
