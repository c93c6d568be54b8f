"""Tanimoto-kernel GP for molecular fingerprints (port of
sober_tpu/gp/tanimoto.py): the exact GP with the Tanimoto kernel plugged
in. On the card its Grams run through the tensor-core kernel of
`ops/tanimoto_gram.py`, and the fit checks its fingerprints once, at its
end."""
from __future__ import annotations

import torch

from ..ops.kernels import tanimoto_gram
from ..ops.tanimoto_gram import check_fingerprints
from ..utils import timing
from .exact import GPConfig, GPState, fit_gp_padded


def batch_tanimoto_sim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bit-vector Tanimoto similarity <x,y>/(|x|^2+|y|^2-<x,y>)
    (SOBER/_drug_modelling.py:15-25)."""
    return tanimoto_gram({"outputscale": torch.ones((), dtype=x.dtype,
                                                    device=x.device)}, x, y)


def fit_tanimoto_gp(x: torch.Tensor, y: torch.Tensor,
                    noise_lo: float = 1e-8, noise_hi: float = 1e-2,
                    optimiser: str = "lbfgs", fit_iters: int = 100,
                    bucket: int = 128) -> GPState:
    """TanimotoGP (SOBER/_drug_modelling.py:103-113): ScaleKernel(Tanimoto)
    exact GP with standardized targets and no hyperpriors, fitted on a
    bucket-padded observation buffer. Raises ValueError if x holds a value
    other than 0 or 1 (`check_fingerprints`). The check is inside the
    recorder's `fit` span, which fit_gp's joins."""
    cfg = GPConfig(kernel_name="tanimoto", noise_lo=noise_lo,
                   noise_hi=noise_hi, train_lik=True, standardize_y=True,
                   use_priors=False, fit_iters=fit_iters)
    with timing.span("fit"):
        state = fit_gp_padded(x, y, cfg, optimiser=optimiser, bucket=bucket)
        check_fingerprints(state.x.device)
    return state
