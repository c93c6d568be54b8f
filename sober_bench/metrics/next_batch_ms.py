"""next_batch_ms: the mean milliseconds of Sober.next_batch a round
(sober_tpu_torch/core/sober.py), a synced span around the benchmark's own
call."""


def read(r):
    ms = [1e3 * s for s in r.spans.get("next_batch", [])]
    return sum(ms) / len(ms) if ms else None
