"""Multi-device batch BO: the full SOBER pipeline on a device mesh.

The torch twin of examples/multichip.py. `Sober(prior, model, mesh=...)`
runs the learned-proposal pipeline (pi sweep, WKDE updates, refill, KMeans
Nystrom, kernel recombination) with the pool-axis sweeps cut over the
mesh's "cand" axis, each shard on its own device. Two schedules:

  * "gspmd" (default): a placement decision, with the results of
    mesh=None;
  * "blockwise": recombination by per-shard reduction trees and one merge
    of their survivors (parallel/sharded.py).

No reference analogue: the reference is single-device. On the GPU: python
examples_torch/multichip.py (the mesh takes every visible card). With
`device` named, the mesh holds n_devices logical shards on that one device
(main(device="cpu", n_devices=8) on the CPU).
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.parallel import make_mesh  # noqa: E402
from sober_tpu_torch.tasks.synthetic import setup_branin  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=10, batch_size=30, n_rec=16384, n_nys=128, n_iterations=5,
         seed=0, n_devices=None, schedule="gspmd", verbose=True, device=None, **_):
    """Returns the history: one (best, acquisition seconds) an iteration.
    n_devices defaults to the visible CUDA cards (at least one)."""
    n_devices = n_devices or max(torch.cuda.device_count(), 1)
    if device is None:
        mesh = make_mesh(n_devices, axis_names=("cand",))
    else:
        mesh = make_mesh(n_devices, axis_names=("cand",),
                         devices=[resolve_device(device)] * n_devices)
    # shard-friendly pool size: divisible by the mesh
    if n_rec < n_devices:
        raise ValueError(
            f"n_rec={n_rec} must be >= n_devices={n_devices} to give every "
            "shard at least one candidate")
    n_rec = (n_rec // n_devices) * n_devices

    prior, objective = setup_branin(seed=seed, device=mesh.devices.flat[0])
    keys = KeyRing(seed, device=prior.device)
    x_all = prior.sample(keys.next(), n_init)
    y_all = objective(x_all)
    best = float(y_all.max())
    history = []

    state = fit_gp_padded(x_all, y_all)
    sober = Sober(prior, state, seed=seed, mesh=mesh, schedule=schedule)

    for it in range(n_iterations):
        start = time.monotonic()
        # the full pipeline on the mesh: proposal resets and updates, the pi
        # sweep, the refill, KMeans Nystrom, the (sharded) recombination
        x_batch = sober.next_batch(n_rec, n_nys, batch_size)
        interval = time.monotonic() - start

        y_batch = objective(x_batch)
        x_all = torch.cat([x_all, x_batch])
        y_all = torch.cat([y_all, y_batch])
        best = max(best, float(y_batch.max()))
        history.append((best, interval))
        if verbose:
            print(f"iter {it}: best {best:.4f}  acq {interval:.3f}s  "
                  f"({n_devices} devices, pool {n_rec}, {schedule})",
                  flush=True)
        state = fit_gp_padded(x_all, y_all)
        sober.update_model(state)
    return history


if __name__ == "__main__":
    main()
