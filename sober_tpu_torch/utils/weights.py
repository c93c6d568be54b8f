"""Importance-weight cleansing (port of sober_tpu/utils/weights.py)."""
from __future__ import annotations

import torch

from ..config import settings


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
