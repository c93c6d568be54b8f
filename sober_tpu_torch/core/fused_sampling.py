"""The acquisition pipelines: the candidate pool, its pi weights, the
proposal update and the Nystrom subset (port of the dataset and continuous
families of sober_tpu/core/fused_sampling.py).

The JAX package traces each family into one program beside a staged twin;
the port runs one eager pipeline per family, with host branches where JAX
has lax.cond and lax.while_loop:

  * dataset (`fused_iteration_dataset`): pi over the whole pool ->
    adaptive top-k pruning -> Nystrom subset by inverse-weight resampling
    -> kernel recombination;
  * continuous (`EmpiricalSampler.sampling_candidates`, from the parts
    here: `pi_weights`, `refill`, `select_nys`): a Uniform (Sobol),
    Gaussian or WKDE proposal -> a pool and its weights -> the
    weight-health branch -> a WKDE refit -> refill rounds -> a KMeans
    Nystrom subset.

The discrete and mixed families wait for ROADMAP.md queue 1, item 10.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.kmeans import kmeans_resampling
from ..utils.weights import (cleansing_weights, deweighted_resampling,
                             weighted_resampling)
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


# ----------------------------------------------------------------------------
# the continuous family
# ----------------------------------------------------------------------------

# rows resampled by weight before KMeans picks the Nystrom centroids
NYS_POOL = 4096


def pi_weights(pi: Callable, x: torch.Tensor, pdf: torch.Tensor) -> torch.Tensor:
    """cleanse(pi(x) / p(x)): a pool's importance weights
    (EmpiricalSampler.sampling, SOBER/_sampler.py:173-187)."""
    return cleansing_weights(pi(x) / torch.clamp_min(pdf, 1e-38))


def refill(draw: Callable, x: torch.Tensor, w: torch.Tensor, need: int,
           bound: int):
    """Accumulate until enough (recursive_sampling, SOBER/_sampler.py:
    205-261): rounds 1..bound-1 each draw a fresh pool (`draw()` -> (x, w))
    and fill the zero-weight rows in place, while at most `need` rows are
    accepted. One host read of the accepted count per round, the first
    included. Returns (x, w, none_accepted, reads); w is uniform when
    nothing was accepted, cleansed otherwise."""
    n_pos, reads = int(torch.sum(w > 0)), 1
    for _ in range(1, bound):
        if n_pos > need:
            break
        x2, w2 = draw()
        fill = (w == 0) & (w2 > 0)
        x = torch.where(fill[:, None], x2, x)
        w = torch.where(fill, w2, w)
        n_pos, reads = int(torch.sum(w > 0)), reads + 1
    if n_pos == 0:
        return x, torch.full_like(w, 1.0 / w.shape[0]), True, reads
    return x, cleansing_weights(w), False, reads


def select_nys(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
               n_nys: int) -> torch.Tensor:
    """Continuous Nystrom subset (SOBER/_sampler.py:316-320): up to
    NYS_POOL rows resampled by weight, sparsified to n_nys KMeans
    centroids."""
    idx = weighted_resampling(gen, w, min(x.shape[0], NYS_POOL))
    return kmeans_resampling(x[idx], n_nys)
