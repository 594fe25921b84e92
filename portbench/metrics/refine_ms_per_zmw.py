"""Milliseconds of the refine loop (the `polish.refine` span: rounds of
K3 scoring and mutation, the straggler continuation) per ZMW it
refined.  The span is timed on the host, and the loop's first blocking
fetch waits for the device work that the setup enqueued (K1's fills),
so this includes the setup's device time too."""


def read(r):
    spans = [(d, a.get("zmws", 0)) for n, d, a in r.spans
             if n == "polish.refine"]
    zmws = sum(z for _, z in spans)
    return 1e3 * sum(d for d, _ in spans) / zmws if zmws else None
