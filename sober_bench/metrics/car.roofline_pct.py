"""car.roofline_pct: the Caratheodory elimination's share of its roofline,
sum of bounds / sum of device time over every call of the public entry
sober_tpu_torch.ops.car.car_eliminate in the profiled stretch. The bound
of a call is counted from its basis's shape and the lanes that the call
eliminated (roofline.car_s), read from its output after the stretch."""
from sober_bench import roofline


def shape(args, kwargs, out):
    big_n = args[1]
    return {"m": big_n.shape[-2], "q": big_n.shape[-1], "elim": out[1]}


ENTRY = ("car", "sober_tpu_torch.ops.car", "car_eliminate", shape)


def read(r):
    calls = r.entries.get("car", [])
    device_s = sum(t for _, t in calls)
    if not calls or device_s <= 0:
        return None
    bound = 0.0
    for s, _ in calls:
        elim = s["elim"].reshape(-1, s["m"]).sum(dim=1).tolist()
        bound += sum(roofline.car_s(s["m"], s["q"], int(n)) for n in elim)
    return 100.0 * bound / device_s
