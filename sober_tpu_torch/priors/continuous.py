"""Continuous priors: Uniform (scrambled Sobol), Gaussian and
TruncatedGaussian (port of sober_tpu/priors/continuous.py;
SOBER/_prior.py:26-184).

The Uniform prior draws Sobol points on the device and advances a sequence
offset across calls, as the JAX package does. TruncatedGaussian samples by
iterative rejection from its parent Gaussian, or by a Gibbs chain
(priors/tmvn.py) when its box holds little mass; its normalization
constant is the Genz box probability (priors/mvn_cdf.py).
"""
from __future__ import annotations

import math

import torch

from ..config import resolve_device
from ..utils.linalg import jitter_cholesky, mvn_logpdf
from ..utils.sobol import sobol_engine, sobol_sample
from .base import BasePrior
from .mvn_cdf import mvn_box_prob
from .tmvn import TruncatedMVN


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


class TruncatedGaussian(BasePrior):
    """Box-truncated multivariate normal (SOBER/_prior.py:133-184), on
    `device` (CUDA unless given).

    `constant` is P(lo < X < hi) by the Genz scan, at least 1e-8. Sampling
    is iterative rejection from the parent Gaussian (`n_rounds` redraws of
    the rows still outside, which are then clipped), or the Gibbs chain of
    `tmvn` with burn_in + thin sweeps when `constant` is below
    `gibbs_threshold` (`_use_gibbs`)."""

    type = "continuous"

    def __init__(self, mu, cov, bounds, n_rounds: int = 10,
                 gibbs_threshold: float = 0.05, device=None):
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.mu = f32(mu)
        self.cov = f32(cov)
        self.bounds = f32(bounds)
        self.device = self.mu.device
        self.n_dims = self.mu.shape[0]
        self.chol, _ = jitter_cholesky(self.cov)
        self.n_rounds = n_rounds
        self.gibbs_threshold = gibbs_threshold
        self.constant = torch.clamp_min(
            mvn_box_prob(self.bounds[0], self.bounds[1], self.mu, self.cov), 1e-8)
        self.tmvn = TruncatedMVN(self.mu, self.cov, self.bounds, device=self.device)
        self._use_gibbs = bool(self.constant < gibbs_threshold)

    def _inside(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.bounds[0], self.bounds[1]
        return torch.all(x >= lo[None, :], dim=1) & torch.all(x <= hi[None, :], dim=1)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        if self._use_gibbs:
            return self.tmvn.sample(gen, n)
        return tgauss_reject_sample(gen, self.mu, self.chol, self.bounds[0],
                                    self.bounds[1], n, self.n_rounds)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        base = torch.exp(mvn_logpdf(x, self.mu, self.chol)) / self.constant
        return torch.where(self._inside(x), base, 0.0)


def tgauss_reject_sample(gen: torch.Generator, mu, chol, lb, ub, n: int,
                         n_rounds: int) -> torch.Tensor:
    """Iterative-rejection draws from a box-truncated Gaussian: a draw of n
    rows, then n_rounds fresh draws, each replacing the rows still outside
    the closed box; the rows outside after that are clipped onto it (the
    reference warns and returns fewer samples, SOBER/_tmvn.py:113-119). No
    host read."""
    d = mu.shape[0]

    def draw():
        z = torch.randn((n, d), generator=gen, device=mu.device)
        return mu[None, :] + z @ chol.T

    def outside(x):
        return ~(torch.all(x >= lb[None, :], dim=1) & torch.all(x <= ub[None, :], dim=1))

    x = draw()
    for _ in range(n_rounds):
        x = torch.where(outside(x)[:, None], draw(), x)
    return torch.minimum(torch.maximum(x, lb[None, :]), ub[None, :])
