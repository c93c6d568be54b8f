"""prog.fit_steps.exact: the optimiser steps of a fit (the program's
counter fit.steps), a mean over the fits of the traced window.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", counters="fit.steps")
