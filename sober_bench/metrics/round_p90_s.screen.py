"""round_p90_s.screen: round_p90_s as a per-layer reading of a screening
cell: the 90th percentile of every round of the traced window, each from
its start to the next round's start (see round_s.screen for why it is not
an end-to-end metric there)."""


def read(r):
    return r.e2e.get("round_p90_s")
