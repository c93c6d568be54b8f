"""rbf_gram.roofline_pct: the RBF Gram's share of its roofline,
sum of bounds / sum of device time over every call of the public entry
sober_tpu_torch.ops.rbf_gram.rbf_gram in the profiled stretch. The bound of
a call is counted from its shapes (roofline.rbf_gram_s); the time is that of
all the device work launched inside the call, whatever implements it."""
from sober_bench import roofline


def shape(args, kwargs, out):
    _, x, y = args[:3]
    return {"n": x.shape[0], "m": y.shape[0], "d": x.shape[1]}


ENTRY = ("rbf_gram", "sober_tpu_torch.ops.rbf_gram", "rbf_gram", shape)


def read(r):
    calls = [(s, t) for s, t in r.entries.get("rbf_gram", []) if s["n"] * s["m"] > 0]
    device_s = sum(t for _, t in calls)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(roofline.rbf_gram_s(**s) for s, _ in calls) / device_s
