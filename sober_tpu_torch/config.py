"""Global numerical settings (port of sober_tpu/config.py:Settings).

Only the fields the ported slice reads are kept: the dtype policy is fixed
to float32 by the package (sober_tpu_torch/__init__.py). `resolve_device`
is the port's device default: constructors that are not handed tensors put
theirs on CUDA unless the caller asks for another device."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Settings:
    # machine epsilon used for weight cleansing (reference: torch.finfo().eps
    # in SOBER/_weights.py:7)
    eps_weights: float = float(torch.finfo(torch.float32).eps)
    # maximum PSD-repair jitter escalations (reference: SOBER/_utils.py:87)
    max_psd_iter: int = 10


_SETTINGS = Settings()


def settings() -> Settings:
    return _SETTINGS


def resolve_device(device=None) -> torch.device:
    """The device a constructor puts its tensors on: CUDA unless the caller
    names another. There is no fallback to the CPU: without a CUDA device,
    torch raises when the first tensor is made there."""
    return torch.device("cuda") if device is None else torch.device(device)
