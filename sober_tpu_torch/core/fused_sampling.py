"""The dataset-domain acquisition pipeline (port of the dataset family of
sober_tpu/core/fused_sampling.py).

pi over the whole pool -> adaptive top-k pruning -> Nystrom subset by
inverse-weight resampling -> kernel recombination, with the batch mapped
back to dataset rows. The JAX package traces this into one program beside
a staged twin; the port runs it eagerly, once: the staged
`EmpiricalSampler.sampling_datasets` calls `dataset_candidates` below.
The other domain families are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.weights import cleansing_weights, deweighted_resampling
from .rchq import _top, recombination


def adaptive_pruning(weights: torch.Tensor, n_rec: int, n_nys: int,
                     thresh: float):
    """Static top-k pruning (SOBER/_sampler.py:325-349): the indices of the
    n_rec largest weights, ties to the lower index as jax.lax.top_k, and
    which of them to keep: those above `thresh`, and the first n_nys in any
    case. Returns (idx_top (k,), keep (k,) bool), k = min(n_rec, N)."""
    k = min(n_rec, weights.shape[0])
    w_top, idx_top = _top(weights, k)
    rank = torch.arange(k, device=weights.device)
    return idx_top, (w_top > thresh) | (rank < n_nys)


def dataset_candidates(w_all: torch.Tensor, x_all: torch.Tensor,
                       avail_mask: torch.Tensor, gen: torch.Generator,
                       n_rec: int, n_nys: int, thresh: float, prune: bool):
    """Pool weights w_all (N,) over x_all (N, d) -> (idx_sampled, x_cand,
    x_nys, w): the pruned pool's dataset rows, features and cleansed
    weights, and the Nystrom subset drawn from it with `gen`."""
    w_all = torch.where(avail_mask, w_all, 0.0)
    if prune:
        idx_sampled, keep = adaptive_pruning(w_all, n_rec, n_nys, thresh)
        x_cand = x_all[idx_sampled]
        w = torch.where(keep, w_all[idx_sampled], 0.0)
    else:
        idx_sampled = torch.arange(x_all.shape[0], device=x_all.device)
        x_cand = x_all
        w = w_all
    w = cleansing_weights(w)
    idx_nys = deweighted_resampling(gen, w, n_nys)
    return idx_sampled, x_cand, x_cand[idx_nys], w


def fused_iteration_dataset(pi: Callable, x_all: torch.Tensor,
                            avail_mask: torch.Tensor, gen: torch.Generator,
                            kernel: Callable, *, n_rec: int, n_nys: int,
                            thresh: float, batch: int, prune: bool,
                            calc_obj: Optional[Callable] = None):
    """One dataset-domain acquisition. pi: X -> (N,) weights; kernel: the
    recombination Gram; calc_obj: optional X -> (N,) objective to push.

    Returns (idx_global, x_batch, w_rchq, n_pos): the batch's dataset rows,
    features and quadrature weights, and the count of positive pool weights
    (a device scalar)."""
    idx_sampled, x_cand, x_nys, w = dataset_candidates(
        pi(x_all), x_all, avail_mask, gen, n_rec, n_nys, thresh, prune)
    idx, w_rchq = recombination(x_cand, x_nys, batch, kernel,
                                init_weights=w, calc_obj=calc_obj)
    return idx_sampled[idx], x_cand[idx], w_rchq, torch.sum(w > 0)
