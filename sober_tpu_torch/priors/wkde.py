"""Weighted kernel density estimation, the learned continuous proposal
(port of sober_tpu/priors/wkde.py; SOBER/_wkde.py:11-248).

The WKDE is refit every batch from the importance weights and becomes the
proposal of the next candidate pool. As in the JAX package, fit, pdf and
sample are functions over a parameter dict (the class holds one): a fixed
number of components (n_kde), one shared covariance, its Cholesky factor
and log normalizer. None of them reads the device from the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import resolve_device
from ..utils.linalg import jitter_cholesky, make_psd
from ..utils.weights import (check_weights, cleansing_weights,
                             deweighted_resampling)
from .base import BasePrior

# candidate rows per block of the pdf: a block's (rows, n_kde) float32
# temporary is 1 GiB at n_kde = 4096
PDF_ROWS = 65_536


def wkde_fit(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
             n_kde: int, bw_method: str, n_dims: int) -> dict:
    """Components, bandwidth and shared covariance from a weighted pool
    (SOBER/_wkde.py:53-107). Rich weights are resampled inversely to their
    size (a uniform-izing draw); poor ones keep the positive-weight support
    first, in index order."""
    rich = check_weights(w, thresh=min(n_kde, 5))
    idx_rich = deweighted_resampling(gen, w, n_kde)
    # jnp.argsort is stable; so is this
    idx_poor = torch.argsort(-(w > 0).to(torch.float32), stable=True)[:n_kde]
    idx = torch.where(rich, idx_rich, idx_poor)
    x_obs = x[idx]
    weights = cleansing_weights(w[idx])

    neff = 1.0 / torch.sum(weights ** 2)
    if bw_method == "scott":
        bw = neff ** (-1.0 / (n_dims + 4))
    else:
        bw = (neff * (n_dims + 2.0) / 4.0) ** (-1.0 / (n_dims + 4))

    mean = weights @ x_obs
    resid = x_obs - mean[None, :]
    data_cov = (resid.T * weights[None, :]) @ resid
    data_cov = data_cov / torch.clamp_min(1.0 - torch.sum(weights ** 2), 1e-6)
    covariance = make_psd(data_cov * bw ** 2)
    chol, _ = jitter_cholesky(covariance)
    log_norm = (torch.sum(torch.log(torch.diagonal(chol)))
                + 0.5 * n_dims * math.log(2.0 * math.pi))
    return dict(x_obs=x_obs, weights=weights, covariance=covariance,
                chol=chol, log_norm=log_norm, neff=neff, bw=bw)


def _inside(x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    return (torch.all(x >= bounds[0][None, :], dim=1)
            & torch.all(x <= bounds[1][None, :], dim=1))


def wkde_pdf(params: dict, bounds: Optional[torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """The mixture density at x (n, d); 0 outside the closed box when
    bounds are given. All n x n_kde Gaussians come from one whitened
    squared distance, PDF_ROWS candidate rows at a time, with the block's
    one temporary updated in place."""
    chol = params["chol"]
    whiten = lambda a: torch.linalg.solve_triangular(chol, a.T, upper=False).T
    zo = whiten(params["x_obs"])
    zo2 = torch.sum(zo * zo, dim=1)
    out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], PDF_ROWS):
        z = whiten(x[s:s + PDF_ROWS])
        d2 = torch.addmm(torch.sum(z * z, dim=1, keepdim=True), z, zo.T,
                         alpha=-2.0)
        d2 += zo2[None, :]
        d2.clamp_(min=0.0).mul_(-0.5).sub_(params["log_norm"]).exp_()
        out[s:s + PDF_ROWS] = d2 @ params["weights"]
    if bounds is not None:
        out = torch.where(_inside(x, bounds), out, 0.0)
    return out


def wkde_sample(gen: torch.Generator, params: dict,
                bounds: Optional[torch.Tensor], n: int,
                n_rounds: int = 10) -> torch.Tensor:
    """n draws: components by weight (inverse CDF), Gaussian noise through
    the shared factor; with bounds, rows outside are redrawn for a fixed
    n_rounds and the rest clipped to the box."""
    weights = params["weights"]
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(n, generator=gen, device=weights.device) * cdf[-1]
    comp = torch.clamp_max(torch.searchsorted(cdf, u, right=True),
                           weights.shape[0] - 1)
    centers = params["x_obs"][comp]
    chol = params["chol"]
    draw = lambda: centers + torch.randn(centers.shape, generator=gen,
                                         device=centers.device) @ chol.T
    x = draw()
    if bounds is None:
        return x
    for _ in range(n_rounds):
        x = torch.where(_inside(x, bounds)[:, None], x, draw())
    return torch.clamp(x, bounds[0][None, :], bounds[1][None, :])


class WeightedKernelDensityEstimation(BasePrior):
    type = "continuous"

    def __init__(self, x, w, n_dims: int, bounds=None, n_kde: int = 4096,
                 bw_method: str = "scott",
                 gen: Optional[torch.Generator] = None, device=None):
        """Fit to the pool x (N, d) with weights w (N,), on `device` (CUDA
        unless given); `gen` draws the components (seed 0 by default)."""
        device = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        w = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(0)
        self.n_dims = n_dims
        self.bounds = (None if bounds is None else
                       torch.as_tensor(bounds, dtype=torch.float32, device=device))
        self.n_kde = min(n_kde, x.shape[0])
        self.device = x.device
        self._params = wkde_fit(gen, x, w, self.n_kde, bw_method, n_dims)

    @classmethod
    def from_params(cls, params: dict, n_dims: int, bounds, n_kde: int):
        """Wrap a wkde_fit parameter dict without refitting."""
        new = object.__new__(cls)
        new.n_dims = n_dims
        new.bounds = bounds
        new.n_kde = n_kde
        new.device = params["x_obs"].device
        new._params = params
        return new

    @property
    def x_obs(self):
        return self._params["x_obs"]

    @property
    def weights(self):
        return self._params["weights"]

    @property
    def covariance(self):
        return self._params["covariance"]

    @property
    def chol(self):
        return self._params["chol"]

    @property
    def neff(self):
        return self._params["neff"]

    @property
    def bw(self):
        return self._params["bw"]

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return wkde_pdf(self._params, self.bounds, x)

    def sample(self, gen: torch.Generator, n: int,
               n_rounds: int = 10) -> torch.Tensor:
        return wkde_sample(gen, self._params, self.bounds, n, n_rounds)
