"""car.roofline_pct.screen: the reading of car.roofline_pct in a screening
cell, which reports no round_s end to end; BENCHMARK.json names the metric
it moves there."""
from sober_bench import registry

_base = registry.metric("car.roofline_pct")
ENTRY, read = _base.ENTRY, _base.read
