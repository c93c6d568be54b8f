"""The Sober orchestrator: batch Bayesian optimization as batch Bayesian
quadrature (port of sober_tpu/core/sober.py; SOBER/_sober.py).

One `next_batch` call runs the acquisition: (a proposal reset on
stagnation) -> the pi-weighted candidate pool -> a Nystrom subset ->
kernel recombination -> the batch, with an optional exploit polish on
continuous domains. `step` refits an exact GP first, `step_fbgp` a
fully-Bayesian GP. Ported for every domain: continuous (Uniform, Gaussian,
TruncatedGaussian, WKDE proposals), binary, categorical, mixed and dataset; and for every model
family: the exact GP, the FBGP (gp/fbgp.py) and the warped BQ model
(gp/warped.py).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..gp.exact import (GPConfig, GPState, fit_gp_padded, init_params,
                        param_tensors, polish_posterior_mean,
                        raw_params_from_state)
from ..gp.fbgp import _VBQ_CFG, FBGPAcquisitionFunction, FitboGP, fbgp_refit
from ..ops.tanimoto_gram import check_fingerprints
from .pi import PI
from .rckernel import RecombinationKernel
from .sampler import EmpiricalSampler


class Sober(EmpiricalSampler):
    def __init__(self, prior, model, thresh: int = 5,
                 sampler_type: str = "lfi",
                 kernel_type: str = "predictive_covariance",
                 dataset_pruning: bool = True, seed: int = 0):
        """(SOBER/_sober.py:9-39)

        Args:
          prior: a prior from sober_tpu_torch.priors (Uniform, Gaussian,
                 TruncatedGaussian, WeightedKernelDensityEstimation, BinaryPrior,
                 CategoricalPrior, MixedBinaryPrior, MixedCategoricalPrior
                 or DatasetPrior)
          model: a fitted exact-GP GPState, or a model exposing is_fbgp
                 (gp.fbgp.FullyBayesianGP) or is_bq (gp.warped.ScaleMmltGP)
          thresh: minimum distinct positive weights before the weights are
                  considered degenerate
          sampler_type: "lfi" (likelihood-free inference pi)
          kernel_type: "predictive_covariance" |
                       "weighted_predictive_covariance" | "kernel"
          dataset_pruning: prune dataset candidate pools by pi weight
          seed: seeds the sampler's KeyRing
        """
        self.sampler_type = sampler_type
        self.kernel_type = kernel_type
        self.dataset_pruning = dataset_pruning
        self.check_model_type(model)
        pi, kernel = self.initialisation(model)
        self.n_batches_until_reset = 3
        self.last_timings: dict[str, float] = {}
        # did the last iteration reset the proposal, and how many resets so far
        self.last_reset = False
        self.reset_count = 0
        super().__init__(prior, pi, kernel, thresh=thresh, label=prior.type,
                         seed=seed)

    # -- model wiring --------------------------------------------------------

    def check_model_type(self, model):
        """Model family sniffing (SOBER/_sober.py:41-54)."""
        self.fbgp = hasattr(model, "is_fbgp")
        self.is_bq = not self.fbgp and hasattr(model, "is_bq")
        if self.is_bq:
            self.n_init = len(model.y_log)
        elif getattr(model, "mask", None) is not None:
            self.n_init = int(model.mask.sum())
        else:
            self.n_init = len(model.fobs) if self.fbgp else int(model.y.shape[0])

    def initialisation(self, model):
        """Wire pi and the recombination kernel (SOBER/_sober.py:56-72): the
        model's own for the FBGP and BQ families."""
        if self.fbgp or self.is_bq:
            return model.make_pi(), model.rc_kernel()
        pi = PI(model, label=self.sampler_type)
        kernel = RecombinationKernel(model, mode=self.kernel_type)
        return pi, kernel

    def update_model(self, model):
        """Swap in a refit model, keeping the learned proposal
        (SOBER/_sober.py:74-82). n_init is pinned at construction: the
        stagnation heuristic measures progress since then."""
        n_init = self.n_init
        self.check_model_type(model)
        self.n_init = n_init
        self.pi, self.kernel = self.initialisation(model)

    # -- prior reset heuristic ----------------------------------------------

    def _targets(self) -> np.ndarray:
        """The observations the model holds, padding left out."""
        model = self.pi.model
        if self.is_bq:
            return model.y_log.cpu().numpy()
        y = (model.fobs if self.fbgp else model.y).cpu().numpy()
        if model.mask is not None:
            y = y[model.mask.cpu().numpy() > 0]
        return y

    def should_reset_prior(self, batch_size: int, recycle_prior: bool,
                           targets=None) -> bool:
        """Stagnation heuristic: reset the proposal after 3 non-improving
        batches (SOBER/_sober.py:84-123), on the host. `targets` overrides
        the model's observations (`step` runs it before the refit, on the
        targets it is about to fit). Dataset domains never reset."""
        if targets is None:
            targets = self._targets()
        learning_length = len(targets) - self.n_init
        if learning_length <= 0 or learning_length == batch_size:
            return False
        cummax = np.maximum.accumulate(targets)
        reached = np.flatnonzero(np.diff(cummax >= targets.max()))
        idx_max = int(reached[0]) if len(reached) else 0
        n_iterations = int(np.ceil(learning_length / batch_size))
        n_batches = 1
        for n_batches in range(1, n_iterations + 1):
            if n_batches * batch_size >= idx_max:
                break
        n_nonimproved = n_iterations - n_batches + 2
        return n_nonimproved >= self.n_batches_until_reset or not recycle_prior

    def _mark_reset(self):
        """initialise_prior, with the reset's bookkeeping."""
        self.last_reset = True
        self.reset_count += 1
        self.initialise_prior()

    # -- main entries --------------------------------------------------------

    def next_batch(self, n_rec: int, n_nys: int, batch_size: int,
                   calc_obj=None, return_weights: bool = False,
                   recycle_prior: bool = True, verbose: bool = False,
                   polish: bool = False):
        """Sample the next batch by kernel recombination
        (SOBER/_sober.py:125-195).

        Returns X_batch (batch_size, d); (global_indices, X_batch) for a
        dataset domain; (w, X_batch) with return_weights=True. calc_obj:
        optional callable X -> (N,) acquisition values to push within the
        quadrature constraints. recycle_prior=False resets a non-dataset
        proposal to the domain prior at every call whose model holds new
        observations (should_reset_prior).

        polish: the exploit polish (no reference analogue): the
        lowest-weight batch point is replaced by the best of 8 projected-Adam
        ascents of the posterior mean (gp.exact.polish_posterior_mean).
        Only for pure-BO selection on a bounded continuous proposal:
        quadrature batches (return_weights) stay recombination-exact, and
        calc_obj already spends the batch's degree of freedom.

        verbose: print the stages, each timed by the host clock after a
        device sync (last_timings keeps them)."""
        t0 = time.monotonic()
        self.last_reset = False
        if self.label != "dataset" and self.should_reset_prior(
                batch_size, recycle_prior):
            if verbose:
                print("The prior was initialised.")
            self._mark_reset()
        return self._acquire(n_rec, n_nys, batch_size, calc_obj,
                             return_weights, verbose, polish, t0)

    def step(self, x_obs, y_obs, n_rec: int, n_nys: int, batch_size: int,
             cfg: GPConfig | None = None, optimiser: str = "adam",
             bucket: int = 128, recycle_prior: bool = True,
             return_weights: bool = False, polish: bool = False,
             warm_start: bool = False):
        """One BO iteration: the reset heuristic on y_obs, a bucket-padded
        GP MAP refit on (x_obs, y_obs), update_model, and the acquisition
        of next_batch. The JAX package traces this into one program; it is
        equivalent to fit_gp_padded -> update_model -> next_batch.

        warm_start: start the refit from the current model's hypers
        (gp.exact.raw_params_from_state), or cold when their shapes do not
        match `cfg` (an isotropic state under an ARD cfg)."""
        if self.fbgp or self.is_bq:
            raise TypeError(
                "Sober.step refits a plain exact GP and would replace this "
                "sampler's FBGP/BQ model; refit it explicitly and call "
                "update_model + next_batch")
        t0 = time.monotonic()
        self.last_reset = False
        cfg = GPConfig() if cfg is None else cfg
        x_obs = torch.as_tensor(x_obs, dtype=torch.float32, device=self.keys.device)
        y_obs = torch.as_tensor(y_obs, dtype=torch.float32,
                                device=self.keys.device).reshape(-1)
        if self.label != "dataset" and self.should_reset_prior(
                batch_size, recycle_prior, targets=y_obs.cpu().numpy()):
            self._mark_reset()
        params0 = (self._warm_start_params(cfg, x_obs.shape[1]) if warm_start
                   else None)
        self.update_model(fit_gp_padded(x_obs, y_obs, cfg, optimiser=optimiser,
                                        bucket=bucket, params0=params0))
        return self._acquire(n_rec, n_nys, batch_size, None, return_weights,
                             False, polish, t0)

    def step_fbgp(self, x_obs, y_obs, hyperprior, n_rec: int, n_nys: int,
                  batch_size: int, n_hypers: int = 1000,
                  n_nys_qd: int = 100, n_qd: int = 50,
                  cfg: GPConfig | None = None, optimiser: str = "lbfgs",
                  alpha_factor: float = 1.0, bucket: int = 128,
                  recycle_prior: bool = True, return_weights: bool = False,
                  calc_obj=None):
        """One fully-Bayesian BO iteration, the FBGP analogue of `step`: the
        reset heuristic on y_obs, then a bucket-padded WSABI-warped base MAP
        fit (gp.fbgp.FitboGP with `cfg`), the hyper pipeline
        (gp.fbgp.fbgp_refit: the LML sweep over n_hypers draws, the
        distillation to n_qd chains, the chain caches), update_model with
        the new FullyBayesianGP, and the acquisition of next_batch. The JAX
        package traces this into one program; here it runs eagerly, one
        pipeline for every proposal family. Returns X_batch, or (w, X_batch)
        with return_weights.

        hyperprior: gp.fbgp.RBFHyperPrior; its n_ls must match the base
        config (1 isotropic, d for cfg.ard). cfg defaults to FitboGP's fit
        config. calc_obj: an FBGP acquisition label ("EI", "UCB", "MES",
        "BQBC", "QBMGP") or an FBGPAcquisitionFunction (its label is used),
        evaluated on the refit model."""
        acq_label = getattr(calc_obj, "label", calc_obj)
        if acq_label is not None and acq_label not in FBGPAcquisitionFunction.LABELS:
            raise ValueError(
                f"calc_obj must be one of {FBGPAcquisitionFunction.LABELS} (or "
                f"an FBGPAcquisitionFunction); got {calc_obj!r}")
        cfg = _VBQ_CFG if cfg is None else cfg
        dev = self.keys.device
        x_obs = torch.as_tensor(x_obs, dtype=torch.float32, device=dev)
        y_obs = torch.as_tensor(y_obs, dtype=torch.float32, device=dev).reshape(-1)
        n_ls_needed = x_obs.shape[1] if cfg.ard else 1
        if hyperprior.n_ls != n_ls_needed:
            raise ValueError(
                f"hyperprior.n_ls={hyperprior.n_ls} does not match the base "
                f"config ({'ARD, ' if cfg.ard else 'isotropic, '}needs "
                f"n_ls={n_ls_needed}); construct RBFHyperPrior(n_ls={n_ls_needed})")
        t0 = time.monotonic()
        self.last_reset = False
        if self.label != "dataset" and self.should_reset_prior(
                batch_size, recycle_prior, targets=y_obs.cpu().numpy()):
            self._mark_reset()
        gp = FitboGP(x_obs, y_obs, alpha_factor=alpha_factor, optimiser=optimiser,
                     bucket=bucket, cfg=cfg)
        model = fbgp_refit(gp, hyperprior, n_hypers=n_hypers, n_nys=n_nys_qd,
                           n_qd=n_qd, gen=self.keys.next())
        self.update_model(model)
        obj = None if acq_label is None else FBGPAcquisitionFunction(model, acq_label)
        return self._acquire(n_rec, n_nys, batch_size, obj, return_weights,
                             False, False, t0)

    # -- the acquisition -------------------------------------------------------

    def _acquire(self, n_rec, n_nys, batch_size, calc_obj, return_weights,
                 verbose, polish, t0):
        """Candidates, recombination, the polish; the tail of next_batch
        and step."""
        def mark():
            if verbose and self.keys.device.type == "cuda":
                torch.cuda.synchronize(self.keys.device)
            return time.monotonic()

        idx_global = None
        if self.label == "dataset":
            idx_global, x_batch, w_rchq = self._fused_dataset_iteration(
                n_rec, n_nys, batch_size, self.dataset_pruning,
                calc_obj=calc_obj)
            # the one host read of the flag the Tanimoto Grams' packs raise
            check_fingerprints(self.prior.device)
            t2 = mark()
            self.last_timings = {"fused_iteration": t2 - t0}
        else:
            x_cand, x_nys, weights = self.sampling_candidates(n_rec, n_nys)
            t1 = mark()
            idx, w_rchq = self.sampling_recombination(
                x_cand, x_nys, weights, batch_size, calc_obj=calc_obj)
            x_batch = x_cand[idx]
            self.last_npos = torch.sum(weights > 0)
            t2 = mark()
            self.last_timings = {"candidates": t1 - t0,
                                 "recombination": t2 - t1}
        self.last_path = "fused"
        if self._polish_eligible(polish, calc_obj, return_weights):
            x_batch = self._exploit_polish(x_batch)
            self.last_timings["polish"] = mark() - t2
        self.last_timings["total"] = mark() - t0
        if verbose:
            print("--- " + ", ".join(f"{k} {v:.3e}" for k, v in
                                      self.last_timings.items()) + " [s]")
        if return_weights:
            return w_rchq, x_batch
        if idx_global is not None:
            return idx_global, x_batch
        return x_batch

    def _warm_start_params(self, cfg: GPConfig, n_dims: int):
        """The current model's raw hypers, or None when their shapes differ
        from what `cfg` would initialise."""
        state = self.pi.model
        if not isinstance(state, GPState):
            return None
        cand = raw_params_from_state(state)
        ref = init_params(cfg, n_dims, device=state.x.device)
        have, want = param_tensors(cand), param_tensors(ref)
        if len(have) != len(want) or any(a.shape != b.shape
                                         for a, b in zip(have, want)):
            return None
        return cand

    def _polish_eligible(self, polish: bool, calc_obj,
                         return_weights: bool) -> bool:
        """The exploit polish's guard (see next_batch's `polish`)."""
        return (polish and calc_obj is None and not return_weights
                and self.label == "continuous"
                and not (self.fbgp or self.is_bq)
                and isinstance(self.pi.model, GPState)
                and getattr(self.prior, "bounds", None) is not None)

    def _exploit_polish(self, x_batch: torch.Tensor) -> torch.Tensor:
        """Replace the lowest-weight batch point with the best of 8
        posterior-mean ascents, started at the incumbent and the 7 heaviest
        batch points (recombination returns those first)."""
        state: GPState = self.pi.model
        y = state.y
        if state.mask is not None:
            y = torch.where(state.mask > 0, y, -torch.inf)
        incumbent = state.x[torch.argmax(y)]
        n_head = min(7, x_batch.shape[0] - 1)
        starts = torch.cat([incumbent[None, :], x_batch[:n_head]])
        lo, hi = self.prior.bounds[0], self.prior.bounds[1]
        x_pol, mu_pol = polish_posterior_mean(state, starts, lo, hi)
        x_batch = x_batch.clone()
        x_batch[-1] = x_pol[torch.argmax(mu_pol)]
        return x_batch
