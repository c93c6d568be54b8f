"""Importance-weight cleansing and resampling (port of
sober_tpu/utils/weights.py).

Resampling without replacement uses the Gumbel-top-k trick, as the JAX
package does: one fixed-shape top-k instead of a sequential multinomial
draw, with the same distribution."""
from __future__ import annotations

import torch

from ..config import settings

DEFAULT_THRESH = 5  # reference anomaly threshold (SOBER/_weights.py:8)


def cleansing_weights(weights: torch.Tensor,
                      eps: float | None = None) -> torch.Tensor:
    """Scrub and normalize weights (SOBER/_weights.py:21-38), keeping the
    reference's order: w < eps -> 0 (negatives, small, -inf), then
    +inf -> eps, NaN -> eps, then normalize; all-zero -> uniform."""
    if eps is None:
        eps = settings().eps_weights
    w = torch.where(weights < eps, 0.0, weights)
    w = torch.where(torch.isinf(w), eps, w)
    w = torch.where(torch.isnan(w), eps, w)
    total = torch.sum(w)
    uniform = torch.full_like(w, 1.0 / w.shape[0])
    return torch.where(total > 0, w / torch.where(total > 0, total, 1.0),
                       uniform)


def check_weights(weights: torch.Tensor,
                  thresh: int = DEFAULT_THRESH) -> torch.Tensor:
    """True if the weights are usable: a nonzero total and at least
    `thresh` distinct values (SOBER/_weights.py:40-55). A 0-dim bool tensor
    on the weights' device."""
    total_ok = torch.sum(weights) != 0
    s = torch.sort(weights).values
    n_unique = 1 + torch.sum(s[1:] != s[:-1])
    return total_ok & (n_unique >= thresh)


def weighted_resampling(gen: torch.Generator, weights: torch.Tensor,
                        n: int) -> torch.Tensor:
    """`n` indices drawn without replacement in proportion to `weights`.

    Gumbel-top-k, as sober_tpu/utils/weights.py:weighted_resampling: the
    n largest of log w + Gumbel noise, the noise drawn from `gen` (a
    generator on the weights' device). Zero weights score -1e30 plus noise,
    so they come in only when fewer than n weights are positive. Ties keep
    the lower index, as jax.lax.top_k does."""
    u = torch.rand(weights.shape, generator=gen, dtype=torch.float32,
                   device=weights.device)
    # away from 0 and 1, where -log(-log(u)) is infinite
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(u, tiny, 1.0 - torch.finfo(torch.float32).eps)
    g = -torch.log(-torch.log(u))
    logw = torch.log(torch.clamp_min(weights, 1e-38))
    score = torch.where(weights > 0, logw + g, -1e30 + g)
    return torch.sort(score, descending=True, stable=True).indices[:n]


def deweighted_resampling(gen: torch.Generator, weights: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Resampling inversely to the weights (SOBER/_weights.py:79-93)."""
    return weighted_resampling(gen, cleansing_weights(1.0 / weights), n)
