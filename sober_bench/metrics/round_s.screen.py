"""round_s.screen: round_s as a per-layer reading of a screening cell: the
traced window's seconds over the rounds completed in it, its spans, host
reads and profiler included. Screening's rounds are bound by the host's
launches and reads, and spread between processes too widely to hold to a
bound end to end; here the figure is kept, ungated."""


def read(r):
    return r.e2e.get("round_s")
