"""Shared batch-BO loops of the torch example scripts (the port of
examples/common.py).

run_bo_loop: initial sample -> [fit GP -> next_batch -> query -> append] x N,
printing the best value and the wall-clock of each batch (the reference's
examples/ackley.py:61-102). run_dataset_loop: the same on a dataset prior
with a Tanimoto GP, the queried rows consumed (examples/malaria.py:22-40,
with the seed and the bucket of tools/acceptance.py:run_dataset).
"""
from __future__ import annotations

import time

import torch

from sober_tpu_torch import Sober
from sober_tpu_torch.gp.exact import fit_gp_padded
from sober_tpu_torch.gp.tanimoto import fit_tanimoto_gp
from sober_tpu_torch.utils.prng import KeyRing


def _record(sober, y_all, history, interval, telemetry):
    """Append (interval, best) to history and, with telemetry, the
    iteration's reset flag, path and positive-weight count: the best and
    the count come to the host in one read."""
    if telemetry is None or sober.last_npos is None:
        best, n_pos = float(y_all.max()), None
    else:
        best, n_pos = torch.stack([y_all.max(),
                                   sober.last_npos.to(y_all.dtype)]).tolist()
        n_pos = int(n_pos)
    history.append((interval, best))
    if telemetry is not None:
        telemetry.append({"reset": bool(sober.last_reset),
                          "path": sober.last_path, "n_pos": n_pos})
    return best


def run_bo_loop(prior, fn, n_init=100, batch_size=200, n_rec=20000,
                n_nys=500, n_iterations=15, seed=0, gp_kwargs=None,
                verbose=True, polish=False, telemetry=None):
    """Returns (x_all, y_all, history), history one (acquisition seconds,
    best) an iteration. telemetry: optional list; one dict an iteration is
    appended with the stagnation-reset flag, the path taken and the pool's
    positive-weight count (tools/acceptance_torch.py). The keys, the GP and
    Sober live on the prior's device."""
    keys = KeyRing(seed, device=prior.device)
    gp_kwargs = gp_kwargs or {}
    x_all = prior.sample(keys.next(), n_init)
    y_all = fn(x_all)
    # bucket-padded fit: the padded shapes stay fixed until the observation
    # count crosses a bucket boundary
    model = fit_gp_padded(x_all, y_all, **gp_kwargs)
    sober = Sober(prior, model, seed=seed)

    history = []
    for _ in range(n_iterations):
        start = time.monotonic()
        model = fit_gp_padded(x_all, y_all, **gp_kwargs)
        sober.update_model(model)
        x_batch = sober.next_batch(n_rec, n_nys, batch_size, polish=polish)
        interval = time.monotonic() - start

        y_batch = fn(x_batch)
        x_all = torch.cat([x_all, x_batch])
        y_all = torch.cat([y_all, y_batch])
        best = _record(sober, y_all, history, interval, telemetry)
        if verbose:
            print(f"{len(x_all)}) Best value: {best:.5e}")
            print(f"Acquisition time [s]: {interval:.5e}, per sample [ms]: "
                  f"{interval / batch_size * 1e3:.5e}")
    return x_all, y_all, history


def run_dataset_loop(prior, n_init=100, batch_size=100, n_rec=2000,
                     n_nys=500, n_iterations=15, seed=0, bucket=128,
                     verbose=True, telemetry=None):
    """The dataset-domain loop on a DatasetPrior: a Tanimoto GP refit, the
    weighted-predictive-covariance recombination, the batch's rows queried
    and consumed. Returns (x_all, y_all, history) as run_bo_loop."""
    keys = KeyRing(seed, device=prior.device)
    x_all, y_all = prior.sample(keys.next(), n_init)
    model = fit_tanimoto_gp(x_all, y_all, bucket=bucket)
    sober = Sober(prior, model, seed=seed,
                  kernel_type="weighted_predictive_covariance")

    history = []
    for _ in range(n_iterations):
        start = time.monotonic()
        model = fit_tanimoto_gp(x_all, y_all, bucket=bucket)
        sober.update_model(model)
        idx_batch, x_batch = sober.next_batch(n_rec, n_nys, batch_size)
        interval = time.monotonic() - start
        y_batch = prior.query(idx_batch)
        x_all = torch.cat([x_all, x_batch])
        y_all = torch.cat([y_all, y_batch])
        best = _record(sober, y_all, history, interval, telemetry)
        if verbose:
            print(f"{len(x_all)}) Best value: {best:.5e}")
            print(f"Acquisition time [s]: {interval:.5e}")
    return x_all, y_all, history
