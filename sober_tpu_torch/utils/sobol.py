"""Scrambled Sobol quasi-Monte-Carlo points (port of
sober_tpu/utils/sobol.py).

scipy builds the scrambled direction numbers on the host once (its
Joe-Kuo table, LMS scramble and digital shift); the points themselves come
from the Gray-code formula on the device,

    x_i = shift XOR ( XOR_{k : bit k of gray(i) set} v_k ),  gray(i) = i ^ (i >> 1),

so a pool of any offset and length is drawn with no host transfer. torch's
bitwise ops on uint32 are incomplete, so the 30-bit values ride in int64;
the float32 conversion and the 2^-bits scale are those of the JAX package,
and the points agree with its bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device


class SobolState(NamedTuple):
    sv: torch.Tensor      # (d, bits) int64 direction numbers (scrambled)
    shift: torch.Tensor   # (d,) int64 digital shift
    bits: int             # number of bits (30 for scipy's table)


def sobol_engine(n_dims: int, seed: int = 0, scramble: bool = True,
                 device=None) -> SobolState:
    """Direction numbers of scipy's scrambled Sobol engine for `seed`, on
    `device` (CUDA unless given)."""
    from scipy.stats import qmc

    eng = qmc.Sobol(n_dims, scramble=scramble, seed=seed)
    sv = np.asarray(eng._sv, dtype=np.uint32)
    shift = (np.asarray(eng._shift, dtype=np.uint32) if scramble
             else np.zeros(n_dims, dtype=np.uint32))
    return sobol_state(sv, shift, int(eng.bits), device)


def sobol_state(sv, shift, bits: int, device=None) -> SobolState:
    """A SobolState from direction numbers and shift given as numpy arrays
    (uint32 values)."""
    device = resolve_device(device)
    as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return SobolState(as_long(sv), as_long(shift), int(bits))


def sobol_sample(state: SobolState, start: int, n: int) -> torch.Tensor:
    """Points [start, start + n) of the sequence, (n, d) float32 in [0, 1).
    Indices wrap at 2^32, as the JAX package's uint32 counter does."""
    sv, shift, bits = state
    i = (torch.arange(n, dtype=torch.int64, device=sv.device) + int(start)) & 0xFFFFFFFF
    g = i ^ (i >> 1)                                       # Gray code
    acc = shift[None, :].expand(n, -1).clone()
    for k in range(bits):
        acc ^= ((g >> k) & 1)[:, None] * sv[None, :, k]
    return acc.to(torch.float32) * (2.0 ** -bits)
