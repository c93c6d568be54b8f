"""Batch BO on Hartmann6 (truth 3.32237).

The torch twin of examples/hartmann.py. On the GPU:
python examples_torch/hartmann.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_hartmann  # noqa: E402


def main(device=None, **overrides):
    cfg = dict(n_init=100, batch_size=100, n_rec=20000, n_nys=500, n_iterations=15)
    cfg.update(overrides)
    prior, fn = setup_hartmann(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
