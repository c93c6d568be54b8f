"""next_batch_host_reads.screen: the reading of next_batch_host_reads in a screening cell, which reports no
round_s end to end; BENCHMARK.json names the metric it moves there."""
from sober_bench import registry

read = registry.metric("next_batch_host_reads").read
