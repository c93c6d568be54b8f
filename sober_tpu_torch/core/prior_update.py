"""Proposal updates: the proposal refit to the current importance weights
(port of sober_tpu/core/prior_update.py; SOBER/_prior_update.py).

Continuous dimensions are refit as a weighted KDE. The Bernoulli and
categorical updates take the closed-form weighted MLE, the weighted
empirical frequency, clamped away from 0 (and 1) so that every value keeps
being explored, as the JAX package does in place of the reference's
L-BFGS fit of the same likelihood.
"""
from __future__ import annotations

import copy

import torch

from ..priors.discrete import BinaryPrior, CategoricalPrior
from ..priors.wkde import WeightedKernelDensityEstimation

_P_CLAMP = 1e-3


def bernoulli_mle(weights: torch.Tensor, x_binary: torch.Tensor) -> torch.Tensor:
    """p_d = sum_i w_i x_id / sum_i w_i, clamped to [1e-3, 1 - 1e-3]."""
    total = torch.clamp_min(torch.sum(weights), 1e-30)
    return torch.clamp((weights @ x_binary) / total, _P_CLAMP, 1.0 - _P_CLAMP)


def categorical_mle(weights: torch.Tensor, idx: torch.Tensor, n_dims: int,
                    c_max: int) -> torch.Tensor:
    """Per-dimension weighted category frequencies of the indices idx
    (n, d), clamped below at 1e-3: (d, c_max)."""
    one_hot = torch.nn.functional.one_hot(idx.long(), c_max).to(weights.dtype)
    counts = torch.einsum("n,ndc->dc", weights, one_hot)
    total = torch.clamp_min(torch.sum(counts, dim=1, keepdim=True), 1e-30)
    return torch.clamp(counts / total, _P_CLAMP, 1.0)


def update_binary_prior(weights, x_binary, prior_binary: BinaryPrior) -> BinaryPrior:
    """(SOBER/_prior_update.py:231-245)"""
    return BinaryPrior(prior_binary.n_dims, probs=bernoulli_mle(weights, x_binary),
                       device=weights.device)


def update_categorical_prior(weights, x_idx, prior: CategoricalPrior) -> CategoricalPrior:
    """x_idx holds category indices (n, d) (SOBER/_prior_update.py:247-261).
    The masses are the MLE's probabilities, 0 on padding."""
    new = copy.copy(prior)
    p = categorical_mle(weights, x_idx, prior.n_dims, prior.c_max)
    new.weights = torch.where(prior.valid_mask, p, 0.0)
    return new


def update_continuous_prior(x_cand: torch.Tensor, weights: torch.Tensor, prior,
                            n_dims: int, gen: torch.Generator | None = None
                            ) -> WeightedKernelDensityEstimation:
    """A WKDE fit to the weighted pool, bounded by the prior's box if it has
    one (SOBER/_prior_update.py:263-284); on the pool's device."""
    return WeightedKernelDensityEstimation(
        x_cand, weights, n_dims, bounds=getattr(prior, "bounds", None),
        gen=gen, device=x_cand.device)


def update_mixed_prior(x_cand: torch.Tensor, weights: torch.Tensor, prior,
                       label: str = "binary", gen: torch.Generator | None = None):
    """Both blocks of a mixed prior refit (SOBER/_prior_update.py:286-313):
    the discrete block by its MLE, the continuous block as a WKDE bounded by
    the domain's box. For label "categorical" the discrete block of x_cand
    holds category indices. Returns a new prior; `prior` is unchanged."""
    x_cont, x_disc = prior.separate_samples(x_cand)
    new = copy.copy(prior)
    if label == "binary":
        new.prior_disc = update_binary_prior(weights, x_disc, prior.prior_disc)
        new.prior_binary = new.prior_disc
    elif label == "categorical":
        new.prior_disc = update_categorical_prior(weights, x_disc, prior.prior_disc)
    else:
        raise ValueError("label should be 'binary' or 'categorical'")
    new.prior_cont = update_continuous_prior(x_cont, weights, prior.prior_cont,
                                             prior.n_dims_cont, gen=gen)
    return new
