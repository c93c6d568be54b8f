"""fit_ms.tanimoto: the mean milliseconds of the Tanimoto-GP fit a round
(sober_tpu_torch/gp/tanimoto.py:fit_tanimoto_gp), a synced span around the
benchmark's own call. Nothing when the cell fits no Tanimoto GP."""


def read(r):
    ms = [1e3 * s for s in r.spans.get("fit.tanimoto", [])]
    return sum(ms) / len(ms) if ms else None
