"""prog.cholesky_retries.exact: the retries of the fit's Cholesky factor at a
1e-2 jitter in a fit (the program's counter fit.cholesky_retries), a mean
over the fits of the traced window.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", counters="fit.cholesky_retries")
