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
proposal, Sobol offset included; so does a discrete or mixed one
(`discrete_prior_to_numpy`, `discrete_prior_from_numpy`). The models of
the FBGP and warped-BQ families go across too: a FitboGP (its GPState, the
warp's alpha, its padded targets), an RBFHyperPrior, a FullyBayesianGP (the
distilled weights and chains, their caches L^-1 and alpha, the padded
observations, mask and eta) and a ScaleMmltGP (its h-space GPState, beta and
log-likelihoods): `fitbo_gp_*`, `hyperprior_*`, `fbgp_*` and `scale_mmlt_*`,
each `_to_numpy` and `_from_numpy`, so that both packages compute on the
same model. A parabolic mean's parameters and priors ride in the GP dicts
(`mean_params`, the config's `mean_priors`). A TruncatedGaussian goes across
as its mu, cov, bounds, rounds and regime (`truncated_gaussian_*`), and the
ECM simulator as its parameters, frequencies and observed spectrum
(`ecm_from_numpy`), whose noise JAX draws from a stream torch cannot
redraw. The multitask GPs and the pathwise sampler's basis go across as
well: an ICMState (its inputs, caches and kernel id), a MultiTaskGPState
(one GP dict a task, sliced from JAX's batched state) and an RFFBasis
(`icm_state_*`, `multitask_gp_*`, `rff_basis_*`). Nothing here imports
jax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .gp.exact import GPConfig, GPParams, GPState
from .gp.fbgp import ChainCache, FitboGP, FullyBayesianGP, RBFHyperPrior
from .gp.multitask import ICMState, MultiTaskGPState
from .gp.sampling import RFFBasis
from .gp.warped import ScaleMmltGP
from .ops.kernels import Kernel
from .priors.continuous import Gaussian, TruncatedGaussian, Uniform
from .priors.dataset import DatasetPrior
from .priors.discrete import (BinaryPrior, CategoricalPrior, MixedBinaryPrior,
                              MixedCategoricalPrior)
from .priors.wkde import WeightedKernelDensityEstimation
from .tasks.ecm import CanonicalECMTwoRCs
from .utils.sobol import sobol_state

_CONFIG_FIELDS = {f.name for f in dataclasses.fields(GPConfig)}
_STATE_ARRAYS = ("noise", "x", "y", "y_mean", "y_std", "chol", "alpha", "mask",
                 "linv")


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.array(a, dtype=np.float32),
                           device=resolve_device(device))


def _mean_params(d: dict, device) -> dict:
    return {k: _tensor(v, device) for k, v in (d.get("mean_params") or {}).items()}


def gp_params_from_numpy(d: dict, device=None) -> GPParams:
    """GPParams from {raw_lengthscale, raw_outputscale, raw_noise[,
    mean_params (a dict)]} numpy arrays."""
    return GPParams(_tensor(d["raw_lengthscale"], device),
                    _tensor(d["raw_outputscale"], device),
                    _tensor(d["raw_noise"], device), _mean_params(d, device))


def gp_config_from_dict(d: dict) -> GPConfig:
    """GPConfig from a dict of sober_tpu GPConfig fields; a field the port
    lacks must be None."""
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
            "mean_params": {k: arr(v) for k, v in state.mean_params.items()},
            **{k: arr(getattr(state, k)) for k in _STATE_ARRAYS}}


def gp_state_from_numpy(d: dict, device=None) -> GPState:
    """GPState from a dict of the fields of sober_tpu's GPState: config
    (dict), kernel_name, kernel_params (dict), noise, x, y, y_mean, y_std,
    chol, alpha, mask (or None), linv (or None)[, mean_params (a dict)]."""
    kernel = Kernel(d["kernel_name"],
                    {k: _tensor(v, device) for k, v in d["kernel_params"].items()})
    arrays = {k: _tensor(d.get(k), device) for k in _STATE_ARRAYS}
    return GPState(config=gp_config_from_dict(d["config"]), kernel=kernel,
                   mean_params=_mean_params(d, device), **arrays)


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


def discrete_prior_to_numpy(prior) -> dict:
    """The dict `discrete_prior_from_numpy` reads, from a sober_tpu
    BinaryPrior (its probs), CategoricalPrior (its categories and padded
    (d, C_max) masses) or mixed prior (its continuous block as
    `continuous_prior_to_numpy` gives it, its discrete block, bounds and
    layout), with arrays read by np.asarray."""
    if hasattr(prior, "prior_cont"):
        return {"family": prior.type, "bounds": np.asarray(prior.bounds),
                "continous_first": bool(prior.continous_first),
                "continuous": continuous_prior_to_numpy(prior.prior_cont),
                "discrete": discrete_prior_to_numpy(prior.prior_disc)}
    if hasattr(prior, "categories"):
        return {"family": "categorical",
                "categories": [list(map(float, c)) for c in prior.categories],
                "weights": np.asarray(prior.weights)}
    return {"family": "binary", "probs": np.asarray(prior.probs)}


def discrete_prior_from_numpy(d: dict, device=None):
    """The port's BinaryPrior, CategoricalPrior, MixedBinaryPrior or
    MixedCategoricalPrior from a dict of numpy arrays: the masses, and a
    mixed prior's continuous block (a Uniform with its Sobol offset, or a
    WKDE), carried over."""
    device = resolve_device(device)
    if d["family"] == "binary":
        return BinaryPrior(len(d["probs"]), probs=_tensor(d["probs"], device),
                           device=device)
    if d["family"] == "categorical":
        prior = CategoricalPrior(d["categories"], device=device)
        prior.weights = _tensor(d["weights"], device)
        return prior
    disc = discrete_prior_from_numpy(d["discrete"], device)
    n_cont = np.shape(d["bounds"])[1]
    if d["family"] == "mixedbinary":
        prior = MixedBinaryPrior(n_cont, disc.n_dims, d["bounds"], d["continous_first"],
                                 device=device)
        prior.prior_binary = disc
    else:
        prior = MixedCategoricalPrior(n_cont, disc.n_dims, disc.categories, d["bounds"],
                                      d["continous_first"], device=device)
    prior.prior_disc = disc
    prior.prior_cont = continuous_prior_from_numpy(d["continuous"], device)
    return prior


def fitbo_gp_to_numpy(gp) -> dict:
    """The dict `fitbo_gp_from_numpy` reads, from a sober_tpu FitboGP."""
    return {"state": gp_state_to_numpy(gp.model), "alpha": np.asarray(gp.alpha),
            "Y_unwarp": np.asarray(gp.Y_unwarp), "x_obs_raw": np.asarray(gp.x_obs_raw),
            "fobs_padded": np.asarray(gp.fobs_padded), "label": gp.label,
            "alpha_factor": gp.alpha_factor, "bucket": gp.bucket,
            "optimiser": gp.optimiser}


def fitbo_gp_from_numpy(d: dict, device=None) -> FitboGP:
    """The port's FitboGP with the fitted state, warp and targets of a
    sober_tpu FitboGP, carried over (no refit)."""
    gp = object.__new__(FitboGP)
    gp.model = gp_state_from_numpy(d["state"], device)
    gp.cfg = gp.model.config
    gp.label, gp.alpha_factor = d["label"], d["alpha_factor"]
    gp.bucket, gp.optimiser, gp.jitter = d["bucket"], d["optimiser"], 0.0
    for k in ("alpha", "Y_unwarp", "x_obs_raw", "fobs_padded"):
        setattr(gp, k, _tensor(d[k], device))
    return gp


def hyperprior_to_numpy(hp) -> dict:
    """The dict `hyperprior_from_numpy` reads, from a sober_tpu RBFHyperPrior."""
    return {"n_ls": hp.n_ls, "hypermu": np.asarray(hp.hypermu),
            "hyperstd": np.asarray(hp.hyperstd)}


def hyperprior_from_numpy(d: dict, device=None) -> RBFHyperPrior:
    """The port's RBFHyperPrior with the same location and scale."""
    device = resolve_device(device)
    hp = RBFHyperPrior(n_ls=d["n_ls"], device=device)
    hp.hypermu, hp.hyperstd = _tensor(d["hypermu"], device), _tensor(d["hyperstd"], device)
    return hp


def fbgp_to_numpy(model) -> dict:
    """The dict `fbgp_from_numpy` reads, from a sober_tpu FullyBayesianGP."""
    arr = lambda a: None if a is None else np.asarray(a)
    return {"Xobs": arr(model.Xobs), "fobs": arr(model.fobs), "mask": arr(model.mask),
            "eta": arr(model.eta), "w_qd": arr(model.w_qd),
            "Theta_qd": arr(model.Theta_qd), "linv": arr(model._cache.linv),
            "alpha": arr(model._cache.alpha)}


def fbgp_from_numpy(d: dict, device=None) -> FullyBayesianGP:
    """The port's FullyBayesianGP on the same chains, weights and caches."""
    t = {k: _tensor(v, device) for k, v in d.items()}
    return FullyBayesianGP.from_arrays(t["Xobs"], t["fobs"], t["mask"], t["eta"],
                                       t["w_qd"], t["Theta_qd"],
                                       ChainCache(t["linv"], t["alpha"]))


def scale_mmlt_to_numpy(model) -> dict:
    """The dict `scale_mmlt_from_numpy` reads, from a sober_tpu ScaleMmltGP."""
    return {"state": gp_state_to_numpy(model.model), "beta": np.asarray(model.beta),
            "y_log": np.asarray(model.y_log), "kernel_name": model.kernel_name,
            "optimiser": model.optimiser}


def scale_mmlt_from_numpy(d: dict, device=None) -> ScaleMmltGP:
    """The port's ScaleMmltGP with the h-space state, beta and
    log-likelihoods of a sober_tpu ScaleMmltGP, carried over (no refit)."""
    m = object.__new__(ScaleMmltGP)
    m.model = gp_state_from_numpy(d["state"], device)
    m.cfg, m.kernel_name, m.optimiser, m.jitter = (
        m.model.config, d["kernel_name"], d["optimiser"], 0.0)
    m.beta, m.y_log = _tensor(d["beta"], device), _tensor(d["y_log"], device)
    return m


def truncated_gaussian_to_numpy(prior, gibbs_threshold: float = 0.05) -> dict:
    """The dict `truncated_gaussian_from_numpy` reads, from a sober_tpu
    TruncatedGaussian (which keeps no threshold: pass the one it was built
    with) and the regime it samples in."""
    return {"mu": np.array(prior.mu), "cov": np.array(prior.cov),
            "bounds": np.array(prior.bounds), "n_rounds": int(prior.n_rounds),
            "gibbs_threshold": float(gibbs_threshold),
            "use_gibbs": bool(prior._use_gibbs)}


def truncated_gaussian_from_numpy(d: dict, device=None) -> TruncatedGaussian:
    """The port's TruncatedGaussian with the same mu, cov, bounds and rounds,
    pinned to the carried regime (its own Genz constant could land an ulp
    across the threshold)."""
    device = resolve_device(device)
    prior = TruncatedGaussian(d["mu"], d["cov"], d["bounds"], n_rounds=d["n_rounds"],
                              gibbs_threshold=d["gibbs_threshold"], device=device)
    prior._use_gibbs = bool(d.get("use_gibbs", prior._use_gibbs))
    return prior


def ecm_to_numpy(sim) -> dict:
    """The dict `ecm_from_numpy` reads, from a sober_tpu CanonicalECMTwoRCs."""
    return {"theta_true": np.array(sim.theta_true), "sigma": float(sim.noise_sig),
            "omega": np.array(sim.omega), "reZ": np.array(sim.reZ),
            "imZ": np.array(sim.imZ)}


def ecm_from_numpy(d: dict, device=None) -> CanonicalECMTwoRCs:
    """The port's ECM simulator on the same parameters and frequencies,
    with the carried observed spectrum in place of its own noisy draw."""
    device = resolve_device(device)
    sim = CanonicalECMTwoRCs(*np.asarray(d["theta_true"], np.float64).tolist(),
                             sigma=d["sigma"], omega=d["omega"], device=device)
    sim.reZ, sim.imZ = _tensor(d["reZ"], device), _tensor(d["imZ"], device)
    return sim


_ICM_ARRAYS = ("x", "yt", "y_mean", "y_std", "lengthscale", "noise", "task_cov", "qx",
               "lx", "qb", "lb", "alpha")


def icm_state_to_numpy(st) -> dict:
    """The dict `icm_state_from_numpy` reads, from a sober_tpu ICMState."""
    return {**{k: np.asarray(getattr(st, k)) for k in _ICM_ARRAYS},
            "kernel_id": int(np.asarray(st.kernel_id))}


def icm_state_from_numpy(d: dict, device=None) -> ICMState:
    """The port's ICMState with the fitted hypers, task covariance and
    eigen-caches of a sober_tpu ICMState, carried over (no refit)."""
    return ICMState(**{k: _tensor(d[k], device) for k in _ICM_ARRAYS},
                    kernel_id=int(d["kernel_id"]))


def multitask_gp_to_numpy(mt) -> dict:
    """The dict `multitask_gp_from_numpy` reads, from a sober_tpu
    MultiTaskGPState: its batched GPState sliced into one dict a task."""
    batched = gp_state_to_numpy(mt.states)
    take = lambda a, t: None if a is None else a[t]
    states = []
    for t in range(mt.n_tasks):
        one = {k: (take(v, t) if k in _STATE_ARRAYS else v) for k, v in batched.items()}
        one["kernel_params"] = {k: v[t] for k, v in batched["kernel_params"].items()}
        one["mean_params"] = {k: v[t] for k, v in batched["mean_params"].items()}
        states.append(one)
    return {"n_tasks": int(mt.n_tasks), "states": states}


def multitask_gp_from_numpy(d: dict, device=None) -> MultiTaskGPState:
    """The port's MultiTaskGPState, one carried GPState a task."""
    return MultiTaskGPState(tuple(gp_state_from_numpy(s, device) for s in d["states"]),
                            d["n_tasks"])


def rff_basis_to_numpy(basis) -> dict:
    """The dict `rff_basis_from_numpy` reads, from a sober_tpu RFFBasis."""
    return {k: np.asarray(getattr(basis, k)) for k in RFFBasis._fields}


def rff_basis_from_numpy(d: dict, device=None) -> RFFBasis:
    """The port's RFFBasis on the same frequencies, phases and scales."""
    return RFFBasis(*(_tensor(d[k], device) for k in RFFBasis._fields))
