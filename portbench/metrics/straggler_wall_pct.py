"""Share of the refine loop's host time spent in the straggler
continuation: the `polish.straggler` spans' profiler ranges that lie in
a `polish.refine` range, over the `polish.refine` ranges, in %.  0 where
no batch leaves stragglers; nothing where the program records no
`polish.round` spans (one that does not trace its refine loop)."""


def read(r):
    refine = [(s, e) for n, s, e in r.host if n == "polish.refine"]
    if not refine or not any(n == "polish.round" for n, _, _ in r.host):
        return None
    strag = sum(e - s for n, s, e in r.host if n == "polish.straggler"
                and any(a <= s and e <= b for a, b in refine))
    return 100.0 * strag / sum(e - s for s, e in refine)
