"""prog.fit_ms.exact: the stream milliseconds of the program's `fit` span
(gp/exact.py:fit_gp, under fit_gp_padded), a mean over the fits of the
traced window, each episode's first fit included.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", span="fit", scale=1e3)
