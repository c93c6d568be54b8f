"""Batch BO on Ising sparsification (24 binary edges).

The torch twin of examples/ising.py; the reference's n_rec=2e5, examples/ising.py:69. On the GPU:
python examples_torch/ising.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_ising  # noqa: E402


def main(device=None, **overrides):
    cfg = dict(n_init=100, batch_size=100, n_rec=200000, n_nys=500, n_iterations=15)
    cfg.update(overrides)
    prior, fn = setup_ising(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
