"""prog.adam_fallbacks.tanimoto: the whole Adam fits that a fit falls back to
when L-BFGS ends above its start (the program's counter fit.adam_fallbacks),
a mean over the fits of the traced window.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", counters="fit.adam_fallbacks")
