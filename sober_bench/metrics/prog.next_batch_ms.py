"""prog.next_batch_ms: the stream milliseconds of the program's
`next_batch` span (core/sober.py:Sober.next_batch), a mean over the calls.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("next_batch", span="next_batch", scale=1e3)
