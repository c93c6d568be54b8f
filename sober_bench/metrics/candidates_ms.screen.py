"""candidates_ms.screen: the reading of candidates_ms in a screening cell, which reports no
round_s end to end; BENCHMARK.json names the metric it moves there."""
from sober_bench import registry

read = registry.metric("candidates_ms").read
