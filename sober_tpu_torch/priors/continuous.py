"""Continuous priors: Uniform (scrambled Sobol) and Gaussian (port of
sober_tpu/priors/continuous.py; SOBER/_prior.py:26-131).

The Uniform prior draws Sobol points on the device and advances a sequence
offset across calls, as the JAX package does. TruncatedGaussian waits for
ROADMAP.md queue 1, item 13.
"""
from __future__ import annotations

import math

import torch

from ..config import resolve_device
from ..utils.linalg import jitter_cholesky, mvn_logpdf
from ..utils.sobol import sobol_engine, sobol_sample
from .base import BasePrior


class Uniform(BasePrior):
    """Uniform prior over a box (SOBER/_prior.py:26-88); bounds (2, d)."""

    type = "continuous"

    def __init__(self, bounds, seed: int = 0, qmc: bool = True, device=None):
        device = resolve_device(device)
        self.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=device)
        self.device = self.bounds.device
        self.n_dims = self.bounds.shape[1]
        self.qmc = qmc
        self._sobol = sobol_engine(self.n_dims, seed=seed, device=device)
        self._offset = 0

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        if self.qmc:
            u = sobol_sample(self._sobol, self._offset, n)
            self._offset += n
        else:
            u = torch.rand((n, self.n_dims), generator=gen, device=self.device)
        return self.scale(u)

    def scale(self, u: torch.Tensor) -> torch.Tensor:
        """Points u of the unit cube mapped onto the box."""
        lo, hi = self.bounds[0], self.bounds[1]
        return lo[None, :] + (hi - lo)[None, :] * u

    def _in_bounds(self, x: torch.Tensor) -> torch.Tensor:
        # a point on the boundary is outside (SOBER/_prior.py:67-70)
        lo, hi = self.bounds[0], self.bounds[1]
        return torch.all(x > lo[None, :], dim=1) & torch.all(x < hi[None, :], dim=1)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds[0], self.bounds[1]
        return torch.where(self._in_bounds(x), torch.prod(1.0 / (hi - lo)), 0.0)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds[0], self.bounds[1]
        return torch.where(self._in_bounds(x), -torch.sum(torch.log(hi - lo)),
                           -math.inf)


class Gaussian(BasePrior):
    """Multivariate normal prior (SOBER/_prior.py:90-131)."""

    type = "continuous"

    def __init__(self, mu, cov, device=None):
        device = resolve_device(device)
        self.mu = torch.as_tensor(mu, dtype=torch.float32, device=device)
        self.cov = torch.as_tensor(cov, dtype=torch.float32, device=device)
        self.device = self.mu.device
        self.n_dims = self.mu.shape[0]
        self.chol, _ = jitter_cholesky(self.cov)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        z = torch.randn((n, self.n_dims), generator=gen, device=self.device)
        return self.mu[None, :] + z @ self.chol.T

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return mvn_logpdf(x, self.mu, self.chol)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.logpdf(x))
