"""Discrete and mixed priors: Bernoulli, categorical, and the products of a
continuous block with either (port of sober_tpu/priors/discrete.py;
SOBER/_prior.py:186-538).

Ragged categories are padded to a (d, C_max) value table with a valid mask,
so a draw or a density is one batched op over every dimension, as in the
JAX package. Randomness comes from an explicit `torch.Generator`; tensors
live on CUDA unless the caller names a device (`config.resolve_device`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .base import BasePrior
from .continuous import Uniform


class BinaryPrior(BasePrior):
    """Independent Bernoulli prior (SOBER/_prior.py:289-336)."""

    type = "binary"

    def __init__(self, n_dims: int, probs=None, device=None):
        device = resolve_device(device)
        self.n_dims = n_dims
        self.probs = (torch.full((n_dims,), 0.5, device=device) if probs is None
                      else torch.as_tensor(probs, dtype=torch.float32, device=device))
        self.device = self.probs.device

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        u = torch.rand((n, self.n_dims), generator=gen, device=self.device)
        return (u < self.probs[None, :]).to(torch.float32)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.clamp(self.probs, 1e-12, 1 - 1e-12)
        lp = x * torch.log(p)[None, :] + (1 - x) * torch.log1p(-p)[None, :]
        return torch.sum(lp, dim=1)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.logpdf(x))


class CategoricalPrior(BasePrior):
    """Independent categorical prior over per-dimension category values
    (SOBER/_prior.py:186-287). `categories` is a ragged list of value
    lists; `weights` the unnormalized masses, 0.5 each unless given."""

    type = "categorical"

    def __init__(self, categories, weights=None, device=None):
        device = resolve_device(device)
        self.categories = categories
        self.n_dims = len(categories)
        self.c_max = max(len(c) for c in categories)
        table = np.zeros((self.n_dims, self.c_max), np.float32)
        mask = np.zeros((self.n_dims, self.c_max), bool)
        for i, cats in enumerate(categories):
            table[i, :len(cats)] = np.asarray(cats, np.float32)
            mask[i, :len(cats)] = True
        if weights is None:
            w = np.where(mask, 0.5, 0.0).astype(np.float32)
        else:
            w = np.zeros((self.n_dims, self.c_max), np.float32)
            for i, wi in enumerate(weights):
                w[i, :len(wi)] = np.asarray(wi, np.float32)
        self.n_categories = torch.as_tensor([len(c) for c in categories],
                                            dtype=torch.int32, device=device)
        self.value_table = torch.as_tensor(table, device=device)
        self.valid_mask = torch.as_tensor(mask, device=device)
        self.weights = torch.as_tensor(w, device=device)
        self.device = self.value_table.device

    @property
    def probs(self) -> torch.Tensor:
        w = torch.where(self.valid_mask, torch.clamp_min(self.weights, 1e-12), 0.0)
        return w / torch.sum(w, dim=1, keepdim=True)

    def _logits(self) -> torch.Tensor:
        return torch.where(self.valid_mask,
                           torch.log(torch.clamp_min(self.weights, 1e-12)), -torch.inf)

    def sample_both(self, gen: torch.Generator, n: int):
        """(values (n, d) float32, indices (n, d) int64) by Gumbel-argmax
        (SOBER/_prior.py:235-248)."""
        logits = self._logits()
        u = torch.rand((n,) + tuple(logits.shape), generator=gen, device=self.device)
        # away from 0 and 1, where -log(-log(u)) is infinite
        u = torch.clamp(u, torch.finfo(torch.float32).tiny,
                        1.0 - torch.finfo(torch.float32).eps)
        idx = torch.argmax(logits[None] - torch.log(-torch.log(u)), dim=-1)
        rows = torch.arange(self.n_dims, device=self.device)[None, :]
        return self.value_table[rows, idx], idx

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return self.sample_both(gen, n)[0]

    def logpdf_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """Log PMF at category indices (n, d)."""
        rows = torch.arange(self.n_dims, device=self.device)[None, :]
        return torch.sum(torch.log(self.probs)[rows, idx.long()], dim=1)

    def _values_to_indices(self, x: torch.Tensor) -> torch.Tensor:
        """The nearest category of each value, per dimension."""
        diff = torch.abs(x[:, :, None] - self.value_table[None])
        diff = torch.where(self.valid_mask[None], diff, torch.inf)
        return torch.argmin(diff, dim=-1)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.logpdf_indices(self._values_to_indices(x))

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(self.logpdf(x))


class _MixedPrior(BasePrior):
    """A continuous x discrete product prior (SOBER/_prior.py:338-538)."""

    def __init__(self, prior_cont, prior_disc, continuous_first: bool = True):
        self.prior_cont = prior_cont
        self.prior_disc = prior_disc
        self.continous_first = continuous_first  # the reference's spelling
        self.n_dims_cont = prior_cont.n_dims
        self.n_dims_disc = prior_disc.n_dims
        self.n_dims = self.n_dims_cont + self.n_dims_disc
        self.device = prior_disc.device

    def separate_samples(self, x: torch.Tensor):
        """(continuous block, discrete block) of rows x."""
        nc, nd = self.n_dims_cont, self.n_dims_disc
        if self.continous_first:
            return x[:, :nc], x[:, nc:]
        return x[:, nd:], x[:, :nd]

    def _join(self, x_cont: torch.Tensor, x_disc: torch.Tensor) -> torch.Tensor:
        pair = (x_cont, x_disc) if self.continous_first else (x_disc, x_cont)
        return torch.cat(pair, dim=1)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return self._join(self.prior_cont.sample(gen, n), self.prior_disc.sample(gen, n))

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        x_cont, x_disc = self.separate_samples(x)
        return self.prior_cont.logpdf(x_cont) + self.prior_disc.logpdf(x_disc)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        x_cont, x_disc = self.separate_samples(x)
        return self.prior_cont.pdf(x_cont) * self.prior_disc.pdf(x_disc)


class MixedBinaryPrior(_MixedPrior):
    """Uniform x Bernoulli product prior (SOBER/_prior.py:338-434)."""

    type = "mixedbinary"

    def __init__(self, n_dims_cont: int, n_dims_binary: int, bounds,
                 continous_first: bool = True, seed: int = 0, device=None):
        device = resolve_device(device)
        self.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=device)
        self.n_dims_binary = n_dims_binary
        super().__init__(Uniform(self.bounds, seed=seed, device=device),
                         BinaryPrior(n_dims_binary, device=device), continous_first)
        # the reference's name for the discrete block (SOBER/_prior.py:368)
        self.prior_binary = self.prior_disc


class MixedCategoricalPrior(_MixedPrior):
    """Uniform x categorical product prior (SOBER/_prior.py:436-538)."""

    type = "mixedcategorical"

    def __init__(self, n_dims_cont: int, n_dims_disc: int, categories, bounds,
                 continous_first: bool = True, seed: int = 0, device=None):
        device = resolve_device(device)
        self.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=device)
        self.categories = categories
        super().__init__(Uniform(self.bounds, seed=seed, device=device),
                         CategoricalPrior(categories, device=device), continous_first)

    def sample_both(self, gen: torch.Generator, n: int):
        """(values, the same rows with category indices in the discrete
        block) (SOBER/_prior.py:501-523)."""
        x_cont = self.prior_cont.sample(gen, n)
        vals, idx = self.prior_disc.sample_both(gen, n)
        return self._join(x_cont, vals), self._join(x_cont, idx.to(torch.float32))

    def pdf_indices(self, x_with_idx: torch.Tensor) -> torch.Tensor:
        x_cont, idx = self.separate_samples(x_with_idx)
        return (self.prior_cont.pdf(x_cont)
                * torch.exp(self.prior_disc.logpdf_indices(idx.long())))
