"""Synthetic benchmark objectives (port of sober_tpu/tasks/synthetic.py;
experiments/_synthetic_function.py).

Negated, maximization-convention objectives over (n, d) float32 tensors,
computed on the tensor's device, and the setups that pair each with its
Uniform prior. `setup_ackley` and `setup_rosenbrock` need the mixed priors
of ROADMAP.md queue 1, item 10.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..priors.continuous import Uniform


def _const(a, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=x.device)


def ackley(x: torch.Tensor) -> torch.Tensor:
    """Negated Ackley (experiments/_synthetic_function.py:11-22); maximum 0
    at x = 0."""
    x = torch.atleast_2d(x)
    a, b, c = 20.0, 0.2, 2.0 * math.pi
    first = -a * torch.exp(-b * torch.sqrt(torch.mean(x ** 2, dim=1)))
    second = torch.exp(torch.mean(torch.cos(c * x), dim=1))
    return -1.0 * (first - second + a + math.e)


def branin_product(x: torch.Tensor) -> torch.Tensor:
    """The quick-start 'Branin' product function
    (experiments/_synthetic_function.py:24-26); on [-2, 3]^2 its maximum is
    10.6043 at x = (-1.0254, -1.0254)."""
    x = torch.atleast_2d(x)
    num = (torch.sin(x) + torch.cos(3 * x) / 2.0) ** 2
    den = (x / 2.0) ** 2 + 0.3
    return torch.prod(num / den, dim=1)


_HART6_ALPHA = [1.0, 1.2, 3.0, 3.2]
_HART6_A = [[10.0, 3.0, 17.0, 3.5, 1.7, 8.0],
            [0.05, 10.0, 17.0, 0.1, 8.0, 14.0],
            [3.0, 3.5, 1.7, 10.0, 17.0, 8.0],
            [17.0, 8.0, 0.05, 10.0, 0.1, 14.0]]
_HART6_P = (1e-4 * np.array([[1312.0, 1696.0, 5569.0, 124.0, 8283.0, 5886.0],
                             [2329.0, 4135.0, 8307.0, 3736.0, 1004.0, 9991.0],
                             [2348.0, 1451.0, 3522.0, 2883.0, 3047.0, 6650.0],
                             [4047.0, 8828.0, 8732.0, 5743.0, 1091.0, 381.0]]))


def hartmann6(x: torch.Tensor) -> torch.Tensor:
    """Negated Hartmann-6 on [0, 1]^6; maximum 3.32237."""
    x = torch.atleast_2d(x)
    inner = torch.sum(_const(_HART6_A, x)[None]
                      * (x[:, None, :] - _const(_HART6_P, x)[None]) ** 2, dim=2)
    return torch.sum(_const(_HART6_ALPHA, x)[None] * torch.exp(-inner), dim=1)


_SHEKEL_BETA = 0.1 * np.array([1.0, 2.0, 2.0, 4.0, 4.0, 6.0, 3.0, 7.0, 5.0, 5.0])
_SHEKEL_C = [[4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
             [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6],
             [4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
             [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6]]


def shekel(x: torch.Tensor) -> torch.Tensor:
    """Negated Shekel m=10 on [0, 10]^4; maximum 10.5364 at (4, 4, 4, 4)."""
    x = torch.atleast_2d(x)
    d2 = torch.sum((x[:, :, None] - _const(_SHEKEL_C, x)[None]) ** 2, dim=1)
    return torch.sum(1.0 / (d2 + _const(_SHEKEL_BETA, x)[None]), dim=1)


def setup_branin(seed: int = 0, device=None):
    """The quick start (tutorial 00): a Uniform prior on [-2, 3]^2 with the
    product-Branin objective; `seed` scrambles the prior's Sobol stream."""
    return Uniform([[-2.0, -2.0], [3.0, 3.0]], seed=seed, device=device), branin_product


def setup_hartmann(seed: int = 0, device=None):
    """experiments/_hartmann.py: 6 continuous dimensions on [0, 1]."""
    return Uniform([[0.0] * 6, [1.0] * 6], seed=seed, device=device), hartmann6


def setup_shekel(seed: int = 0, device=None):
    """experiments/_shekel.py: 4 continuous dimensions on [0, 10]."""
    return Uniform([[0.0] * 4, [10.0] * 4], seed=seed, device=device), shekel
