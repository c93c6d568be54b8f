"""Gram-matrix kernels (port of sober_tpu/ops/kernels.py).

Kernels are functions of a parameter dict {"lengthscale": scalar or (d,),
"outputscale": scalar} of tensors; the Tanimoto kernel has no lengthscale.
`KERNELS` holds the formulas. `Kernel.gram` computes the RBF Gram with the
hand-written kernel (`ops/rbf_gram.py`) and the others through `KERNELS`,
where the Tanimoto Gram reaches its own hand-written kernel
(`ops/tanimoto_gram.py`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import resolve_device
from .rbf_gram import rbf_gram, rbf_gram_reference, sqdist
from .tanimoto_gram import tanimoto_similarity

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


def _scale(x: torch.Tensor, params: dict) -> torch.Tensor:
    return x / params["lengthscale"]


def matern12_gram(params, x, y):
    r = torch.sqrt(sqdist(_scale(x, params), _scale(y, params)) + 1e-20)
    return params["outputscale"] * torch.exp(-r)


def matern32_gram(params, x, y):
    r = torch.sqrt(sqdist(_scale(x, params), _scale(y, params)) + 1e-20)
    return params["outputscale"] * (1.0 + _SQRT3 * r) * torch.exp(-_SQRT3 * r)


def matern52_gram(params, x, y):
    r2 = sqdist(_scale(x, params), _scale(y, params))
    r = torch.sqrt(r2 + 1e-20)
    return (params["outputscale"] * (1.0 + _SQRT5 * r + (5.0 / 3.0) * r2)
            * torch.exp(-_SQRT5 * r))


def linear_gram(params, x, y):
    return params["outputscale"] * (_scale(x, params) @ _scale(y, params).T)


def tanimoto_gram(params, x, y):
    """Tanimoto similarity of 0/1 fingerprints times the outputscale. The
    outputscale multiplies outside the kernel, so autograd reaches it while
    the fingerprints (which never require grad) go through the CUDA kernel
    on the card."""
    return params["outputscale"] * tanimoto_similarity(x, y)


# the formulas; all but the Tanimoto Gram are plain PyTorch
KERNELS: dict[str, Callable] = {
    "rbf": rbf_gram_reference,
    "matern12": matern12_gram,
    "matern32": matern32_gram,
    "matern52": matern52_gram,
    "linear": linear_gram,
    "tanimoto": tanimoto_gram,
}

# kernels whose params hold no lengthscale
_NO_LENGTHSCALE = frozenset({"tanimoto"})


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Kernel spec: registry name + parameter dict of tensors."""

    name: str
    params: dict

    def gram(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.name == "rbf":
            return rbf_gram(self.params, x, y)
        return KERNELS[self.name](self.params, x, y)

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "linear":
            xs = _scale(x, self.params)
            return self.params["outputscale"] * torch.sum(xs * xs, dim=-1)
        # stationary kernels and Tanimoto: k(x, x) = outputscale
        return self.params["outputscale"].to(x.dtype).expand(x.shape[0])


def make_kernel(name: str, n_dims: int | None = None, ard: bool = False,
                lengthscale: float = 1.0, outputscale: float = 1.0,
                dtype=torch.float32, device=None) -> Kernel:
    """A kernel spec with scalar or ARD params on `device` (CUDA unless
    given)."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    device = resolve_device(device)
    params = {"outputscale": torch.tensor(outputscale, dtype=dtype,
                                          device=device)}
    if name in _NO_LENGTHSCALE:
        return Kernel(name, params)
    if ard:
        if n_dims is None:
            raise ValueError("an ARD kernel needs n_dims")
        params["lengthscale"] = torch.full((n_dims,), lengthscale,
                                           dtype=dtype, device=device)
    else:
        params["lengthscale"] = torch.tensor(lengthscale, dtype=dtype,
                                             device=device)
    return Kernel(name, params)
