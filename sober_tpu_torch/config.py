"""Global numerical settings (port of sober_tpu/config.py:Settings).

Only the fields the port reads are kept: the dtype policy is fixed to
float32 by the package (sober_tpu_torch/__init__.py), and `set_settings`
refuses another. `resolve_device`
is the port's device default: constructors that are not handed tensors put
theirs on CUDA unless the caller asks for another device."""
from __future__ import annotations

import dataclasses

import numpy as np
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


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def set_settings(compute_dtype=None, solve_dtype=None, **kwargs) -> Settings:
    """Replace the process-wide settings (port of sober_tpu/config.py's
    set_settings; SOBER/_settings.py:11-22). Only the port's fields can be
    set: any other name raises TypeError. The dtypes are fixed to float32
    (ROADMAP.md, "Ground rules": fp32 everywhere, lower precision breaks
    batch selection): another raises ValueError."""
    global _SETTINGS
    for dtype in (compute_dtype, solve_dtype):
        if dtype is not None and not _is_float32(dtype):
            raise ValueError(f"dtype {dtype}: the port computes in float32 only "
                             "(ROADMAP.md, Ground rules: fp32 everywhere)")
    fields = {f.name for f in dataclasses.fields(Settings)}
    unknown = sorted(set(kwargs) - fields)
    if unknown:
        raise TypeError(f"settings {unknown} are not the port's; it has {sorted(fields)}")
    _SETTINGS = dataclasses.replace(_SETTINGS, **kwargs)
    return _SETTINGS


def resolve_device(device=None) -> torch.device:
    """The device a constructor puts its tensors on: CUDA unless the caller
    names another. There is no fallback to the CPU: without a CUDA device,
    torch raises when the first tensor is made there."""
    return torch.device("cuda") if device is None else torch.device(device)
