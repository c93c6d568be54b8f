"""device_idle_pct.screen: the reading of device_idle_pct in a screening cell, which reports no
round_s end to end; BENCHMARK.json names the metric it moves there."""
from sober_bench import registry

read = registry.metric("device_idle_pct").read
