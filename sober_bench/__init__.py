"""The benchmark of sober_tpu_torch (the PyTorch and CUDA port of sober_tpu).

One command runs one cell once on one NVIDIA GPU:

    python3 sober_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads/<name>.json``) names a configuration
(``configs/<name>.json`` with its objective or data loader beside it), its
traffic and the limits of its correctness check. A per-layer metric is a
reader of its own (``metrics/<name>.py``). The harness finds all of them by
name, so a cell or a metric is added as new files only. Nothing here imports
jax or the JAX package ``sober_tpu``; the yardstick (traffic, the plain
reference, the roofline arithmetic, the comparison that decides ``correct``)
lives here, where changes to the program cannot reach it.
"""
