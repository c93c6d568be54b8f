"""Quick-start: product-Branin on [-2,3]^2 (tutorial 00).
Ground truth maximum: 10.6043 at (-1.0254, -1.0254).

The torch twin of examples/branin.py. On the GPU:
python examples_torch/branin.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402


def main(device=None, **overrides):
    cfg = dict(n_init=10, batch_size=30, n_rec=20000, n_nys=500, n_iterations=5)
    cfg.update(overrides)
    prior, fn = setup_branin(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
