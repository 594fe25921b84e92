"""Share of the argmax-guided forward refills (real reads x guided
passes) whose log-likelihood was at least the fill's before, so that the
refill was kept, in %: the program's ccs_fill_guided_kept_total over
ccs_fill_guided_reads_total.  Nothing where no guided pass ran (templates
up to 3 kb) or the program lacks the counters."""


def read(r):
    runs = r.counter("ccs_fill_guided_reads_total")
    return 100.0 * r.counter("ccs_fill_guided_kept_total") / runs \
        if runs else None
