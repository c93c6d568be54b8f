"""fit_ms.exact: the mean milliseconds of the exact-GP fit a round
(sober_tpu_torch/gp/exact.py:fit_gp_padded), a span that the benchmark
opens around its own call, synced before and after (the traced run's spans
phase). Nothing when the cell fits no exact GP."""


def read(r):
    ms = [1e3 * s for s in r.spans.get("fit.exact", [])]
    return sum(ms) / len(ms) if ms else None
