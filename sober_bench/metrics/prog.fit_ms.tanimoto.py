"""prog.fit_ms.tanimoto: the stream milliseconds of the program's `fit`
span (gp/tanimoto.py:fit_tanimoto_gp, its fingerprint check included), a
mean over the fits of the traced window, each episode's first included.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", span="fit", scale=1e3)
