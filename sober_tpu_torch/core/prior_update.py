"""Proposal updates: the proposal refit to the current importance weights
(port of sober_tpu/core/prior_update.py; SOBER/_prior_update.py).

Continuous dimensions are refit as a weighted KDE. The Bernoulli and
categorical updates of the discrete domains wait for ROADMAP.md queue 1,
item 10.
"""
from __future__ import annotations

import torch

from ..priors.wkde import WeightedKernelDensityEstimation


def update_continuous_prior(x_cand: torch.Tensor, weights: torch.Tensor, prior,
                            n_dims: int, gen: torch.Generator | None = None
                            ) -> WeightedKernelDensityEstimation:
    """A WKDE fit to the weighted pool, bounded by the prior's box if it has
    one (SOBER/_prior_update.py:263-284); on the pool's device."""
    return WeightedKernelDensityEstimation(
        x_cand, weights, n_dims, bounds=getattr(prior, "bounds", None),
        gen=gen, device=x_cand.device)
