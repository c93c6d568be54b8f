"""Carry a fitted GP and a prior across from the JAX package.

A `sober_tpu` `GPParams` / `GPState` (and the `Kernel` inside) goes across
as a dict of numpy arrays (`gp_state_to_numpy` makes one from a JAX state);
these functions turn such dicts into the port's `GPParams` / `GPState` on a
given device (CUDA unless given; `config.resolve_device`). The dict keys are the field names
of `sober_tpu.gp.exact.GPParams` / `GPState`, with the kernel given as
`kernel_name` and `kernel_params` (a Tanimoto kernel's hold only
`outputscale`) and the config as a dict of `GPConfig` fields. A Tanimoto
GP's params keep their unused `raw_lengthscale`, field for field. A
continuous prior (Uniform, Gaussian, or a WKDE's parameter dict) goes
across the same way (`continuous_prior_to_numpy`,
`continuous_prior_from_numpy`), so that both packages start from the same
proposal, Sobol offset included. Nothing here imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .gp.exact import GPConfig, GPParams, GPState
from .ops.kernels import Kernel
from .priors.continuous import Gaussian, Uniform
from .priors.dataset import DatasetPrior
from .priors.wkde import WeightedKernelDensityEstimation
from .utils.sobol import sobol_state

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(GPConfig)}
_STATE_ARRAYS = ("noise", "x", "y", "y_mean", "y_std", "chol", "alpha", "mask",
                 "linv")


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.array(a, dtype=np.float32),
                           device=resolve_device(device))


def _no_mean_params(d: dict) -> None:
    if d.get("mean_params"):
        raise NotImplementedError("only the zero mean is ported")


def gp_params_from_numpy(d: dict, device=None) -> GPParams:
    """GPParams from {raw_lengthscale, raw_outputscale, raw_noise[,
    mean_params]} numpy arrays."""
    _no_mean_params(d)
    return GPParams(*(_tensor(d[k], device) for k in GPParams._fields))


def gp_config_from_dict(d: dict) -> GPConfig:
    """GPConfig from a dict of sober_tpu GPConfig fields; a field the port
    lacks must be None (e.g. mean_priors)."""
    extra = {k: v for k, v in d.items() if k not in _CONFIG_FIELDS}
    if any(v is not None for v in extra.values()):
        raise NotImplementedError(f"config fields not ported: {sorted(extra)}")
    return GPConfig(**{k: v for k, v in d.items() if k in _CONFIG_FIELDS})


def gp_state_to_numpy(state) -> dict:
    """The dict `gp_state_from_numpy` reads, from a sober_tpu GPState. Its
    arrays are read with np.asarray, so jax is never imported here."""
    arr = lambda a: None if a is None else np.asarray(a)
    return {"config": state.config._asdict(), "kernel_name": state.kernel.name,
            "kernel_params": {k: arr(v) for k, v in state.kernel.params.items()},
            "mean_params": state.mean_params,
            **{k: arr(getattr(state, k)) for k in _STATE_ARRAYS}}


def gp_state_from_numpy(d: dict, device=None) -> GPState:
    """GPState from a dict of the fields of sober_tpu's GPState: config
    (dict), kernel_name, kernel_params (dict), noise, x, y, y_mean, y_std,
    chol, alpha, mask (or None), linv (or None)[, mean_params]."""
    _no_mean_params(d)
    kernel = Kernel(d["kernel_name"],
                    {k: _tensor(v, device) for k, v in d["kernel_params"].items()})
    arrays = {k: _tensor(d.get(k), device) for k in _STATE_ARRAYS}
    return GPState(config=gp_config_from_dict(d["config"]), kernel=kernel,
                   **arrays)


def dataset_prior_from_numpy(features, targets, available=None,
                             device=None) -> DatasetPrior:
    """DatasetPrior from the numpy arrays of a sober_tpu DatasetPrior:
    features (n, d), true_targets (n,) and the `available` mask (n,) bool,
    or None for a fresh pool."""
    prior = DatasetPrior(np.asarray(features, np.float32),
                         np.asarray(targets, np.float32), device=device)
    if available is not None:
        prior.available = torch.as_tensor(np.asarray(available, bool),
                                          device=prior.device)
    return prior


def continuous_prior_to_numpy(prior) -> dict:
    """The dict `continuous_prior_from_numpy` reads, from a sober_tpu
    Uniform, Gaussian or WeightedKernelDensityEstimation (told apart by
    their attributes), with arrays read by np.asarray."""
    arr = lambda a: None if a is None else np.asarray(a)
    if hasattr(prior, "_sobol"):
        sv, shift, bits = prior._sobol
        return {"family": "uniform", "bounds": arr(prior.bounds), "sv": arr(sv),
                "shift": arr(shift), "bits": int(bits),
                "offset": int(prior._offset), "qmc": bool(prior.qmc)}
    if hasattr(prior, "_params"):
        return {"family": "wkde", "n_dims": prior.n_dims, "n_kde": prior.n_kde,
                "bounds": arr(prior.bounds),
                "params": {k: arr(v) for k, v in prior._params.items()}}
    return {"family": "gaussian", "mu": arr(prior.mu), "cov": arr(prior.cov)}


def continuous_prior_from_numpy(d: dict, device=None):
    """The port's Uniform (its Sobol direction numbers, shift and offset
    carried over), Gaussian (its factor recomputed from cov) or WKDE (its
    parameters carried over) from a dict of numpy arrays."""
    device = resolve_device(device)
    if d["family"] == "uniform":
        prior = Uniform(_tensor(d["bounds"], device), qmc=d["qmc"], device=device)
        prior._sobol = sobol_state(d["sv"], d["shift"], d["bits"], device)
        prior._offset = d["offset"]
        return prior
    if d["family"] == "gaussian":
        return Gaussian(_tensor(d["mu"], device), _tensor(d["cov"], device),
                        device=device)
    params = {k: _tensor(v, device) for k, v in d["params"].items()}
    return WeightedKernelDensityEstimation.from_params(
        params, d["n_dims"], _tensor(d["bounds"], device), d["n_kde"])
