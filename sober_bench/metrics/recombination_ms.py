"""recombination_ms: the mean milliseconds a round of the sampler's kernel
recombination (core/sampler.py:sampling_recombination ->
core/rchq.py:recombination), a synced span around the Sober's
sampling_recombination, wrapped from outside; in the dataset path it is the
partial that the fused iteration calls."""


def read(r):
    ms = [1e3 * s for s in r.spans.get("recombination", [])]
    return sum(ms) / len(ms) if ms else None
