"""prog.candidates_ms: the stream milliseconds of the program's
next_batch.candidates span (the draw, the proposal update, refills, the
Nystrom subset; in the dataset path the pi sweep and the pruning), a mean
over the next_batch calls.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("next_batch", span="next_batch.candidates", scale=1e3)
