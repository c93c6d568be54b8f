"""Batch BO on mixed Ackley (3 continuous + 20 binary dims).

The torch twin of examples/ackley.py; the reference's config: examples/ackley.py:68-72. On the GPU:
python examples_torch/ackley.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_ackley  # noqa: E402


def main(device=None, **overrides):
    cfg = dict(n_init=100, batch_size=200, n_rec=20000, n_nys=500, n_iterations=15)
    cfg.update(overrides)
    prior, fn = setup_ackley(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
