"""Importance sampler: pi-weighted candidate pools and kernel recombination
(port of sober_tpu/core/sampler.py; SOBER/_sampler.py).

Only the dataset domain is ported: pi over the whole (masked) pool, static
top-k pruning and an inverse-weight Nystrom subset. The continuous,
discrete and mixed domains (their proposals, proposal updates and refill
draws) wait for ROADMAP.md queue 1, items 8 and 10. The JAX package's
`mesh`/`schedule` arguments wait for item 16.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..priors.base import BasePrior
from ..utils.prng import KeyRing
from . import fused_sampling as fs
from .rchq import recombination

# dataset-domain pruning threshold (SOBER/_sampler.py:325-349)
PRUNE_THRESH = 1e-3


class RecombinationSampler:
    """Kernel recombination step (SOBER/_sampler.py:11-59)."""

    def __init__(self, kernel: Callable, thresh: int = 5, seed: int = 0,
                 device=None):
        self.kernel = kernel
        self.thresh = thresh
        self.keys = KeyRing(seed, device=device)
        # count of positive pool weights of the last iteration (a device
        # scalar, read lazily) and which path produced the batch
        self.last_npos = None
        self.last_path = None

    def sampling_recombination(self, x_cand, x_nys, weights, batch_size,
                               calc_obj=None):
        return recombination(x_cand, x_nys, batch_size, self.kernel,
                             init_weights=weights, calc_obj=calc_obj)


class EmpiricalSampler(RecombinationSampler):
    """pi-importance sampling pipeline (SOBER/_sampler.py:61-382), for a
    dataset prior."""

    def __init__(self, prior: BasePrior, pi, kernel: Callable,
                 thresh: int = 5, label: str = "mixedbinary", seed: int = 0):
        if label != "dataset":
            raise NotImplementedError(
                f"domain label {label!r}: only the dataset domain is ported; "
                "the continuous, discrete and mixed samplers are ROADMAP.md "
                "queue 1, items 8 and 10")
        super().__init__(kernel, thresh=thresh, seed=seed,
                         device=getattr(prior, "device", None))
        self.prior = prior
        self.pi = pi
        self.label = label

    def adaptive_pruning(self, weights, n_rec: int, n_nys: int,
                         thresh: float = PRUNE_THRESH):
        """Static top-k pruning: see fused_sampling.adaptive_pruning."""
        return fs.adaptive_pruning(weights, n_rec, n_nys, thresh)

    def sampling_datasets(self, n_rec: int, n_nys: int,
                          dataset_pruning: bool = True):
        """pi over the whole dataset -> prune -> Nystrom subset
        (SOBER/_sampler.py:351-382). Returns (idx_sampled, X_cand, X_nys,
        weights); idx_sampled maps pool rows to dataset rows."""
        if n_rec <= n_nys:
            raise ValueError(f"n_rec={n_rec} must exceed n_nys={n_nys}")
        x_all = self.prior.available_candidates()
        return fs.dataset_candidates(
            self.pi(x_all), x_all, self.prior.available_mask(),
            self.keys.next(), n_rec, n_nys, PRUNE_THRESH, dataset_pruning)

    def _fused_dataset_iteration(self, n_rec: int, n_nys: int, batch: int,
                                 prune: bool, calc_obj=None):
        """pi sweep + pruning + Nystrom subset + recombination. Returns
        (idx_global, x_batch, w_rchq)."""
        idx_global, x_batch, w_rchq, self.last_npos = (
            fs.fused_iteration_dataset(
                self.pi, self.prior.available_candidates(),
                self.prior.available_mask(), self.keys.next(), self.kernel,
                n_rec=n_rec, n_nys=n_nys, thresh=PRUNE_THRESH, batch=batch,
                prune=prune, calc_obj=calc_obj))
        return idx_global, x_batch, w_rchq
