"""Random-stream threading (port of sober_tpu/utils/prng.py).

The JAX package threads explicit keys through its functional core; the port
threads explicit `torch.Generator`s. A `KeyRing` lives at the host level
(`Sober`, the priors) and hands out a fresh generator, on its device, for
each random draw. The streams differ from JAX's threefry streams for the
same seed, so the tests compare random stages by distribution.
"""
from __future__ import annotations

import torch

from ..config import resolve_device


class KeyRing:
    """A stateful source of independently seeded generators on `device`
    (CUDA unless given; `config.resolve_device`).

    The ring's own generator lives on the CPU, so drawing a new seed never
    waits for the device."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(seed)

    def next(self) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def split(self, n: int) -> list[torch.Generator]:
        return [self.next() for _ in range(n)]
