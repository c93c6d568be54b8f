"""Numerics-safety linear algebra (port of sober_tpu/utils/linalg.py)."""
from __future__ import annotations

import torch

from ..config import settings


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
        return chol, bool(info == 0) and bool(torch.isfinite(chol).all())

    chol, ok = attempt(jit_val)
    tries = 0
    while not ok and tries < max_tries:
        jit_val = 1e-6 * scale if bool(jit_val == 0.0) else jit_val * 10.0
        chol, ok = attempt(jit_val)
        tries += 1
    if not ok:
        chol = torch.diag(torch.sqrt(torch.clamp_min(torch.diagonal(a), 1e-30)))
    return chol, jit_val
