"""prog.fit_host_reads.exact: the program's deliberate host reads in a fit
(its host_reads.<site> counters: the loss, the Cholesky checks, the
final losses, the state's jitter ladder), a mean over the fits.
Importing this file switches the program's recorder on (metrics/_program.py);
the harness imports per-layer readers only for --trace 1, after the warm
episode, so the plain runs never record."""
from sober_bench import registry

read = registry.metric("_program").reader("fit", counters="host_reads")
