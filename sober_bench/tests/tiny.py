"""Cells at a size a CPU test run holds: the same configurations, loops,
reference and limits as on the card, with fewer and smaller rounds."""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TRAFFIC = {
    "shekel-b100": dict(n_init=20, batch=10, n_rec=2000, n_nys=100, rounds=3),
    "solvent-b100": dict(n_init=100, batch=10, n_rec=400, n_nys=100, rounds=3, n_pool=3000),
}


def cell(name: str, device="cpu"):
    import torch

    from sober_bench import harness

    torch.set_num_threads(2)
    return harness.Cell(name, device, traffic=TRAFFIC[name])
