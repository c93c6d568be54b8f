"""prog.library_s: the seconds of the program's setup.library span, the
build or load of the hand-kernel library at its first launch (kept
whether the recorder is on or off).
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").setup_s("setup.library")
