"""The acquisition pipelines: the candidate pool, its pi weights, the
proposal update and the Nystrom subset (port of
sober_tpu/core/fused_sampling.py).

The JAX package traces each family into one program beside a staged twin;
the port runs one eager pipeline per domain, with host branches where JAX
has lax.cond and lax.while_loop:

  * dataset (`fused_iteration_dataset`): pi over the whole pool ->
    adaptive top-k pruning -> Nystrom subset by inverse-weight resampling
    -> kernel recombination;
  * every other label (`EmpiricalSampler.sampling_candidates`, from the
    parts here: `draw`, `pi_weights`, `refill`, `select_nys`): a pool from
    the proposal and its weights -> the weight-health branch -> the
    proposal update -> refill rounds -> a Nystrom subset. `draw` is where
    the families differ: a Uniform (Sobol), Gaussian or WKDE continuous
    proposal, a Bernoulli or categorical one, or a continuous block times
    either (the JAX package's _binary_pipeline, _discrete_pipeline and
    _cont_branches, whose branch structure this is).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.kmeans import kmeans_resampling
from ..priors.continuous import Uniform
from ..utils import timing
from ..utils.weights import (cleansing_weights, deweighted_resampling,
                             weighted_resampling)
from .rchq import _top

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
    with timing.span("sampler.nystrom"):
        idx_nys = deweighted_resampling(gen, w, n_nys)
    return idx_sampled, x_cand, x_cand[idx_nys], w


def fused_iteration_dataset(pi: Callable, x_all: torch.Tensor,
                            avail_mask: torch.Tensor, gen: torch.Generator,
                            recombine: Callable, *, n_rec: int, n_nys: int,
                            thresh: float, batch: int, prune: bool):
    """One dataset-domain acquisition. pi: X -> (N,) weights; recombine:
    (x_cand, x_nys, weights, batch) -> (idx, w), the kernel recombination
    (RecombinationSampler.sampling_recombination).

    Returns (idx_global, x_batch, w_rchq, n_pos): the batch's dataset rows,
    features and quadrature weights, and the count of positive pool weights
    (a device scalar). The recorder's spans: next_batch.candidates, holding
    sampler.pi (the sweep) and sampler.prune, then recombination."""
    with timing.span("next_batch.candidates"):
        with timing.span("sampler.pi"):
            w_all = pi(x_all)
        with timing.span("sampler.prune"):
            idx_sampled, x_cand, x_nys, w = dataset_candidates(
                w_all, x_all, avail_mask, gen, n_rec, n_nys, thresh, prune)
    with timing.span("recombination"):
        idx, w_rchq = recombine(x_cand, x_nys, w, batch)
    return idx_sampled[idx], x_cand[idx], w_rchq, torch.sum(w > 0)


# ----------------------------------------------------------------------------
# the proposal families
# ----------------------------------------------------------------------------

# rows resampled by weight before KMeans picks the Nystrom centroids
NYS_POOL = 4096


def _continuous_draw(prior, gen: torch.Generator, n: int,
                     redraw: bool) -> torch.Tensor:
    """n rows of a continuous proposal. Only a first draw follows (and
    advances) a Uniform's Sobol sequence; its redraws are pseudo-random, as
    the JAX pipeline's refill draws are. A TruncatedGaussian draws by
    rejection, or by its Gibbs chain of burn_in + thin sweeps when its box
    holds little mass (`_use_gibbs`), first draw and refills alike
    (sober_tpu/core/fused_sampling.py:_tgauss_pipeline); its density is
    exp(mvn_logpdf) / constant inside the closed box and 0 outside."""
    if redraw and isinstance(prior, Uniform):
        return prior.scale(torch.rand((n, prior.n_dims), generator=gen,
                                      device=prior.device))
    return prior.sample(gen, n)


def draw(prior, label: str, gen: torch.Generator, n: int, redraw: bool = False,
         sweep: Optional[Callable] = None):
    """A pool of n rows from the proposal of domain `label`: (x, xi, pdf).
    x holds the values; xi, for the categorical labels, the same rows with
    category indices (as floats) in the discrete block, else None; pdf the
    proposal density. A discrete block's density is the exponential of
    the summed log densities, continuous block included, as the JAX
    pipeline computes it (sober_tpu/core/fused_sampling.py:_disc_logpdf
    and _discrete_machinery): it underflows to 0 where that one does.
    sweep: (fn, x) -> fn(x), how a continuous density goes over the pool
    (shard by shard on a mesh: RecombinationSampler._sweep); the elementwise
    discrete densities run whole."""
    sweep = (lambda fn, x: fn(x)) if sweep is None else sweep
    if label == "continuous":
        x = _continuous_draw(prior, gen, n, redraw)
        with timing.span("sampler.pdf"):
            return x, None, sweep(prior.pdf, x)
    if label in ("binary", "categorical"):
        disc, xc, lp = prior, None, 0.0
    else:
        disc = prior.prior_disc
        xc = _continuous_draw(prior.prior_cont, gen, n, redraw)
        with timing.span("sampler.pdf"):
            lp = sweep(prior.prior_cont.logpdf, xc)
    if label.endswith("categorical"):
        xd, idx = disc.sample_both(gen, n)
        lp = lp + disc.logpdf_indices(idx)
        idx = idx.to(torch.float32)
    else:
        xd, idx = disc.sample(gen, n), None
        lp = lp + disc.logpdf(xd)
    if xc is None:
        return xd, idx, torch.exp(lp)
    xi = None if idx is None else prior._join(xc, idx)
    return prior._join(xc, xd), xi, torch.exp(lp)


def pi_weights(pi: Callable, x: torch.Tensor, pdf: torch.Tensor) -> torch.Tensor:
    """cleanse(pi(x) / p(x)): a pool's importance weights
    (EmpiricalSampler.sampling, SOBER/_sampler.py:173-187)."""
    with timing.span("sampler.pi"):
        return cleansing_weights(pi(x) / torch.clamp_min(pdf, 1e-38))


def refill(draw: Callable, x: torch.Tensor, w: torch.Tensor, need: int,
           bound: int):
    """Accumulate until enough (recursive_sampling, SOBER/_sampler.py:
    205-261): rounds 1..bound-1 each draw a fresh pool (`draw()` -> (x, w))
    and fill the zero-weight rows in place, while at most `need` rows are
    accepted. One host read of the accepted count per round, the first
    included; each round is a sampler.refill span, and the recorder's
    counter sampler.n_pos adds the last count. Returns (x, w, none_accepted, reads); w is
    uniform when nothing was accepted, cleansed otherwise."""
    timing.count("host_reads.refill")
    n_pos, reads = int(torch.sum(w > 0)), 1
    for _ in range(1, bound):
        if n_pos > need:
            break
        with timing.span("sampler.refill"):
            timing.count("sampler.refill_rounds")
            x2, w2 = draw()
            fill = (w == 0) & (w2 > 0)
            x = torch.where(fill[:, None], x2, x)
            w = torch.where(fill, w2, w)
            timing.count("host_reads.refill")
            n_pos, reads = int(torch.sum(w > 0)), reads + 1
    timing.count("sampler.n_pos", n_pos)
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
