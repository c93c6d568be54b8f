"""Dataset-as-domain prior with consumable-pool semantics (port of
sober_tpu/priors/dataset.py; DatasetPrior, SOBER/_prior.py:540-655).

The feature matrix stays whole and fixed on the device; a boolean mask on
the same device marks the rows not yet queried. Candidate math runs over
the full matrix with unavailable rows weighted zero, as in the JAX package.
Only the count of available rows (`n_available`, read by `pdf`) and the
uniform draws wait for the device. On CUDA the features are registered as a
pool of `ops/tanimoto_gram.py`: a Tanimoto Gram packs them into bits once,
at the first Gram that takes them, and again only after a write to them.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..ops.tanimoto_gram import POOLS
from .base import BasePrior


class DatasetPrior(BasePrior):
    type = "dataset"

    def __init__(self, features, true_targets, device=None):
        """features (n, d) and true_targets (n,), moved to `device` (CUDA
        unless given; `config.resolve_device`)."""
        self.features = torch.as_tensor(features, dtype=torch.float32,
                                        device=resolve_device(device)).contiguous()
        self.device = self.features.device
        self.true_targets = torch.as_tensor(
            true_targets, dtype=torch.float32, device=self.device).reshape(-1)
        self.n_total, self.n_dims = self.features.shape
        self.available = torch.ones(self.n_total, dtype=torch.bool,
                                    device=self.device)
        if self.device.type == "cuda":
            POOLS.register(self.features)

    @property
    def n_available(self) -> int:
        return int(self.available.sum())

    def available_mask(self) -> torch.Tensor:
        return self.available

    def available_candidates(self) -> torch.Tensor:
        """The full feature matrix; combine with available_mask(). The
        reference returns the physically shrunk matrix
        (SOBER/_prior.py:644-651)."""
        return self.features

    def remove_sampled_index(self, idx_sampled) -> None:
        idx = torch.as_tensor(idx_sampled, device=self.device).reshape(-1)
        self.available[idx] = False

    def query(self, idx_cand) -> torch.Tensor:
        """Targets at global indices, which are then consumed
        (SOBER/_prior.py:597-610)."""
        idx = torch.as_tensor(idx_cand, device=self.device).reshape(-1)
        y = self.true_targets[idx]
        self.remove_sampled_index(idx)
        return y

    def _draw(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n distinct available indices, uniformly (or all of them, in
        random order, when fewer than n are left)."""
        avail_idx = torch.nonzero(self.available).reshape(-1)
        perm = torch.randperm(avail_idx.shape[0], generator=gen,
                              device=self.device)
        return avail_idx[perm[:n]]

    def sample(self, gen: torch.Generator, n: int):
        """(X, Y) drawn uniformly from the available pool, then consumed
        (SOBER/_prior.py:612-628)."""
        chosen = self._draw(gen, n)
        x, y = self.features[chosen], self.true_targets[chosen]
        self.remove_sampled_index(chosen)
        return x, y

    def sample_feature(self, gen: torch.Generator, n: int):
        """(indices, X) drawn uniformly, without consuming
        (SOBER/_prior.py:630-642)."""
        chosen = self._draw(gen, n)
        return chosen, self.features[chosen]

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.full((x.shape[0],), 1.0 / max(self.n_available, 1),
                          dtype=torch.float32, device=x.device)
