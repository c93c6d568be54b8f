"""prog.update_prior_ms: the stream milliseconds of the proposal update
(the program's sampler.update_prior span: the WKDE fit), summed in each
next_batch call, a mean over the calls.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("next_batch", span="sampler.update_prior", scale=1e3)
