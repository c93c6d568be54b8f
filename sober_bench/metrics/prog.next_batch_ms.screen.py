"""prog.next_batch_ms.screen: the reading of prog.next_batch_ms in a screening cell, which
reports no round_s end to end; BENCHMARK.json names the metric it moves there.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("prog.next_batch_ms").read
