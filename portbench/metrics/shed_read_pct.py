"""Share of the reads active when a ZMW's refine started that were no
longer active when it ended (their fills stopped mating after a round of
mutations), in %: the program's ccs_refine_reads_shed_total over
ccs_refine_reads_total.  Nothing where the program counts no refined
read (one that lacks the counters)."""


def read(r):
    reads = r.counter("ccs_refine_reads_total")
    return 100.0 * r.counter("ccs_refine_reads_shed_total") / reads \
        if reads else None
