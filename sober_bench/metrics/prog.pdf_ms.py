"""prog.pdf_ms: the stream milliseconds of the proposal's density over the
pool (the program's sampler.pdf spans: the WKDE pdf), summed in each
next_batch call, a mean over the calls.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("next_batch", span="sampler.pdf", scale=1e3)
