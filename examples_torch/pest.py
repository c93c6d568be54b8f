"""Batch BO on pest control (15 categorical x 5).

The torch twin of examples/pest.py; the reference's n_rec=1e5, examples/pest.py:69. On the GPU:
python examples_torch/pest.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_pest  # noqa: E402


def main(device=None, **overrides):
    cfg = dict(n_init=100, batch_size=100, n_rec=100000, n_nys=500, n_iterations=15)
    cfg.update(overrides)
    prior, fn = setup_pest(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
