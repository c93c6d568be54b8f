"""The acquisition of one batch-BO iteration: pi weighting + kernel
recombination (port of sober_tpu/core/fused.py)."""
from __future__ import annotations

import torch

from ..gp.exact import GPState, predictive_covariance
from ..utils.weights import cleansing_weights
from .pi import lfi
from .rchq import recombination


def fused_acquisition(state: GPState, eta: torch.Tensor, x_cand: torch.Tensor,
                      x_nys: torch.Tensor, prior_pdf: torch.Tensor,
                      batch_size: int):
    """pi-importance weights + RCHQ over the posterior covariance.

    Args: state (fitted GP), eta (incumbent), x_cand (n_rec, d) candidate
    pool, x_nys (n_nys, d) Nystrom subset, prior_pdf (n_rec,) proposal
    density at x_cand, batch_size. Returns (idx, w, weights): the selected
    indices, their quadrature weights and the cleansed pool weights.
    """
    pi_vals = lfi(state, eta, x_cand)
    weights = cleansing_weights(pi_vals / torch.clamp_min(prior_pdf, 1e-38))
    kernel = lambda x, y: predictive_covariance(state, x, y)
    idx, w = recombination(x_cand, x_nys, batch_size, kernel,
                           init_weights=weights)
    return idx, w, weights
