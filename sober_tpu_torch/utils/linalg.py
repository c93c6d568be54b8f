"""Numerics-safety linear algebra (port of sober_tpu/utils/linalg.py):
NaN/Inf scrubbing, PSD repair with escalating jitter, the Gaussian log
density (SOBER/_utils.py:81-199)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import settings
from . import timing


def remove_anomalies(y: torch.Tensor, floor: float | None = None) -> torch.Tensor:
    """Clamp NaN/Inf/very-negative observations to `floor`
    (SOBER/_utils.py:88-99); by default -sqrt(float32 max)."""
    if floor is None:
        floor = -math.sqrt(float(np.finfo(np.float32).max))
    y = torch.nan_to_num(y, nan=floor, posinf=floor, neginf=floor)
    return torch.clamp_min(y, floor)


def remove_anomalies_uniform(x: torch.Tensor, uni_min: torch.Tensor,
                             uni_max: torch.Tensor) -> torch.Tensor:
    """Row mask of inputs inside the closed box [uni_min, uni_max]
    (SOBER/_utils.py:101-115)."""
    return (torch.all(x >= uni_min[None, :], dim=1)
            & torch.all(x <= uni_max[None, :], dim=1))


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def jitter_cholesky(a: torch.Tensor, initial_jitter: float = 0.0,
                    max_tries: int | None = None,
                    floor_rel: float | None = None):
    """Cholesky with escalating diagonal jitter; returns (L, jitter_used).

    The jitter starts at max(initial_jitter, floor_rel * mean|diag|) and is
    multiplied by 10 (or set to 1e-6 * mean|diag| from 0) while the factor
    fails or is non-finite, at most `max_tries` times; after that L falls
    back to the diagonal sqrt(max(diag(a), 1e-30)) (SOBER/_utils.py:154-156).
    `floor_rel` (1e-6 in float32) keeps near-singular fp32 factorizations
    from "succeeding" with garbage pivots (gpytorch's cholesky_jitter).
    """
    if max_tries is None:
        max_tries = settings().max_psd_iter
    a = symmetrize(torch.nan_to_num(a))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    if floor_rel is None:
        floor_rel = 1e-6 if a.dtype == torch.float32 else 1e-12
    scale = torch.clamp_min(torch.mean(torch.abs(torch.diagonal(a))), 1e-30)
    jit_val = torch.clamp_min(floor_rel * scale, initial_jitter)

    def attempt(jit):
        chol, info = torch.linalg.cholesky_ex(a + jit * eye)
        timing.count("host_reads.jitter_cholesky")
        if not bool(info == 0):
            return chol, False
        timing.count("host_reads.jitter_cholesky")
        return chol, bool(torch.isfinite(chol).all())

    chol, ok = attempt(jit_val)
    tries = 0
    while not ok and tries < max_tries:
        timing.count("host_reads.jitter_cholesky")
        jit_val = 1e-6 * scale if bool(jit_val == 0.0) else jit_val * 10.0
        chol, ok = attempt(jit_val)
        tries += 1
    if not ok:
        chol = torch.diag(torch.sqrt(torch.clamp_min(torch.diagonal(a), 1e-30)))
    return chol, jit_val


def make_psd(a: torch.Tensor) -> torch.Tensor:
    """`a` symmetrized and scrubbed, plus the jitter that jitter_cholesky
    needs to factor it (SOBER/_utils.py:131-157)."""
    a = symmetrize(torch.nan_to_num(a))
    _, jit_val = jitter_cholesky(a)
    return a + jit_val * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for PSD a through the jittered Cholesky factor; b is
    (n,) or (n, k)."""
    chol, _ = jitter_cholesky(a)
    if b.dim() == 1:
        return torch.cholesky_solve(b[:, None], chol)[:, 0]
    return torch.cholesky_solve(b, chol)


def mvn_logpdf(x: torch.Tensor, mean: torch.Tensor,
               chol: torch.Tensor) -> torch.Tensor:
    """log N(x; mean, L L^T) for x of shape (..., d)."""
    d = mean.shape[-1]
    diff = x - mean
    flat = diff.reshape(-1, d)
    w = torch.linalg.solve_triangular(chol, flat.T, upper=False)   # (d, N)
    maha = torch.sum(w * w, dim=0).reshape(diff.shape[:-1])
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return -0.5 * (maha + logdet + d * math.log(2.0 * math.pi))


def safe_mvn_prob(mean: torch.Tensor, cov: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """N(x; mean, cov) with the covariance PSD-repaired
    (SOBER/_utils.py:171-194)."""
    chol, _ = jitter_cholesky(cov)
    return torch.exp(mvn_logpdf(x, mean, chol))
