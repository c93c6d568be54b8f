"""Recombination kernel adapters (port of sober_tpu/core/rckernel.py;
SOBER/_kernel.py): a fitted GP as the k(x, y) callable that kernel
recombination consumes. The JAX package's rc_apply/rc_tree protocol and
resolve_rc exist for its jit cache only and are not ported."""
from __future__ import annotations

import torch

from ..gp.exact import GPState, predict_mean, predictive_covariance

MODES = ("predictive_covariance", "weighted_predictive_covariance", "kernel")


class RecombinationKernel:
    """k(x, y) of a fitted GP (SOBER/_kernel.py:4-47), in one of three
    modes: the posterior predictive covariance; the same weighted by the
    posterior means on both sides (for non-negative targets); or the prior
    kernel."""

    def __init__(self, model: GPState, mode: str = "predictive_covariance"):
        if mode not in MODES:
            raise ValueError(f"mode should be one of {MODES}")
        self.model = model
        self.mode = mode

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.mode == "kernel":
            return self.model.kernel.gram(x, y)
        cov = predictive_covariance(self.model, x, y)
        if self.mode == "predictive_covariance":
            return cov
        mu_x = predict_mean(self.model, x)
        mu_y = predict_mean(self.model, y)
        return mu_x[:, None] * cov * mu_y[None, :]
