"""tanimoto_gram.roofline_pct: the Tanimoto Gram's share of its roofline,
sum of bounds / sum of device time over every call of the public entry
sober_tpu_torch.ops.tanimoto_gram.tanimoto_similarity in the profiled
stretch (the packs of its operands included). The bound of a call is
counted from its shapes (roofline.tanimoto_gram_s)."""
from sober_bench import roofline


def shape(args, kwargs, out):
    x, y = args[:2]
    return {"n": x.shape[0], "m": y.shape[0], "d": x.shape[1]}


ENTRY = ("tanimoto_gram", "sober_tpu_torch.ops.tanimoto_gram", "tanimoto_similarity",
         shape)


def read(r):
    calls = [(s, t) for s, t in r.entries.get("tanimoto_gram", []) if s["n"] * s["m"] > 0]
    device_s = sum(t for _, t in calls)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(roofline.tanimoto_gram_s(**s) for s, _ in calls) / device_s
