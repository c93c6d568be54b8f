"""Prior protocol (port of sober_tpu/priors/base.py; BasePrior,
SOBER/_prior.py:12-24).

Every prior exposes sample(gen, n) -> (n, d), pdf(x) -> (n,),
logpdf(x) -> (n,), n_dims and type (one of "continuous", "binary",
"categorical", "mixedbinary", "mixedcategorical", "dataset"). Randomness
comes from an explicit `torch.Generator` on the prior's device.
"""
from __future__ import annotations

import abc

import torch


class BasePrior(abc.ABC):
    type: str = "continuous"
    n_dims: int = 0

    @abc.abstractmethod
    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        ...

    @abc.abstractmethod
    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(torch.clamp_min(self.pdf(x), 1e-38))
