"""pi: the probability measure over global-optimum locations (port of
sober_tpu/core/pi.py). pi(x) = Phi((mu(x) - eta) / sigma(x)), a probability
of improvement over the incumbent eta (the max posterior mean at the
observed inputs)."""
from __future__ import annotations

import math

import torch

from ..gp.exact import GPState, posterior_max_mean, predict

EPS = float(torch.finfo(torch.float32).eps)


def normal_cdf(z: torch.Tensor) -> torch.Tensor:
    """Phi(z) = erfc(-z / sqrt 2) / 2, which keeps the lower tail in float32
    as jax.scipy.stats.norm.cdf does; torch.special.ndtr returns 0 below
    z ~ -5.5 in float32, which zeroes most of a pool's weights far from the
    incumbent and starves the proposal refit."""
    return 0.5 * torch.erfc(-z * math.sqrt(0.5))


def lfi(state: GPState, eta: torch.Tensor, x_cand: torch.Tensor,
        log: bool = False) -> torch.Tensor:
    """Phi((mu - eta) / sigma) at x_cand (SOBER/_pi.py:20-38)."""
    mu, var = predict(state, x_cand)
    val = normal_cdf((mu - eta) / torch.sqrt(var))
    if log:
        return torch.log(val + EPS)
    return val


class PI:
    """pi for a standard GP surrogate (SOBER/_pi.py:5-56); eta is computed
    once at construction, like the reference's PI.__init__."""

    def __init__(self, model: GPState, label: str = "lfi"):
        if label != "lfi":
            raise NotImplementedError(
                "Only the 'lfi' sampler is implemented (the reference's 'ts' "
                "branch raises NotImplementedError too, SOBER/_pi.py:51-52)")
        self.model = model
        self.label = label
        self.eta = posterior_max_mean(model)

    def __call__(self, x_cand: torch.Tensor, log: bool = False) -> torch.Tensor:
        return lfi(self.model, self.eta, x_cand, log=log)
