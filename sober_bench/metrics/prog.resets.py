"""prog.resets: the proposal's resets to the domain prior in a next_batch call
(the program's counter sampler.resets), a mean over the calls.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("next_batch", counters="sampler.resets")
