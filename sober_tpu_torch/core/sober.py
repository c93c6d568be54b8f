"""The Sober orchestrator: batch Bayesian optimization as batch Bayesian
quadrature (port of sober_tpu/core/sober.py; SOBER/_sober.py).

One `next_batch` call runs the acquisition: pi over the candidate pool,
pruning, a Nystrom subset and kernel recombination. Ported for exact-GP
models on dataset domains; the continuous/discrete branches, `step`,
`step_fbgp`, FBGP/BQ models and the exploit polish are ROADMAP.md queue 1,
items 8, 10 and 12.
"""
from __future__ import annotations

import time

import numpy as np

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
          prior: a prior from sober_tpu_torch.priors (DatasetPrior)
          model: a fitted exact-GP GPState
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
        super().__init__(prior, pi, kernel, thresh=thresh, label=prior.type,
                         seed=seed)

    # -- model wiring --------------------------------------------------------

    def check_model_type(self, model):
        """Model family sniffing (SOBER/_sober.py:41-54); only the exact GP
        is ported."""
        if hasattr(model, "is_fbgp") or hasattr(model, "is_bq"):
            raise NotImplementedError(
                "FBGP and warped-BQ models are not ported yet (ROADMAP.md "
                "queue 1, item 12)")
        self.fbgp, self.is_bq = False, False
        if getattr(model, "mask", None) is not None:
            self.n_init = int(model.mask.sum())
        else:
            self.n_init = int(model.y.shape[0])

    def initialisation(self, model):
        """Wire pi and the recombination kernel (SOBER/_sober.py:56-72)."""
        pi = PI(model, label=self.sampler_type)
        kernel = RecombinationKernel(model, mode=self.kernel_type)
        return pi, kernel

    def update_model(self, model):
        """Swap in a refit model (SOBER/_sober.py:74-82). n_init is pinned
        at construction: the stagnation heuristic measures progress since
        then."""
        n_init = self.n_init
        self.check_model_type(model)
        self.n_init = n_init
        self.pi, self.kernel = self.initialisation(model)

    # -- prior reset heuristic ----------------------------------------------

    def _targets(self) -> np.ndarray:
        model = self.pi.model
        y = model.y.detach().cpu().numpy()
        if model.mask is not None:
            y = y[model.mask.detach().cpu().numpy() > 0]
        return y

    def should_reset_prior(self, batch_size: int, recycle_prior: bool,
                           targets=None) -> bool:
        """Stagnation heuristic: reset the proposal after 3 non-improving
        batches (SOBER/_sober.py:84-123), on the host. The dataset domain
        never resets; the continuous and discrete branches that do are not
        ported yet."""
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

    # -- main entry ----------------------------------------------------------

    def next_batch(self, n_rec: int, n_nys: int, batch_size: int,
                   calc_obj=None, return_weights: bool = False,
                   recycle_prior: bool = True, verbose: bool = False,
                   polish: bool = False):
        """Sample the next batch by kernel recombination
        (SOBER/_sober.py:125-195).

        Returns (global_indices, X_batch) for a dataset domain, or
        (w, X_batch) with return_weights=True. calc_obj: optional callable
        X -> (N,) acquisition values to push within the quadrature
        constraints. recycle_prior only matters for the domains whose
        proposal can reset, which are not ported yet."""
        if polish:
            raise NotImplementedError(
                "the exploit polish is for continuous domains (ROADMAP.md "
                "queue 1, item 8)")
        t0 = time.monotonic()
        idx_global, x_batch, w_rchq = self._fused_dataset_iteration(
            n_rec, n_nys, batch_size, self.dataset_pruning, calc_obj=calc_obj)
        if verbose:
            print(f"--- acquisition {time.monotonic() - t0:.3e} [s] "
                  f"(host clock, without a device sync)")
        return self._finish_batch(idx_global, x_batch, w_rchq, t0,
                                  return_weights)

    def step(self, *args, **kwargs):
        raise NotImplementedError(
            "Sober.step (refit + acquisition as one program) is not ported "
            "yet (ROADMAP.md queue 1, item 8): fit the GP, call update_model, "
            "then next_batch")

    def step_fbgp(self, *args, **kwargs):
        raise NotImplementedError(
            "Sober.step_fbgp is not ported yet (ROADMAP.md queue 1, item 12)")

    def _finish_batch(self, idx_global, x_batch, w_rchq, t0,
                      return_weights: bool):
        """Tail of next_batch: the fingerprint check (the one host read of
        the flag that the Tanimoto Grams' packs raise), timings and the
        return value."""
        check_fingerprints(self.prior.device)
        total = time.monotonic() - t0
        self.last_timings = {"fused_iteration": total, "total": total}
        self.last_path = "fused"
        if return_weights:
            return w_rchq, x_batch
        return idx_global, x_batch
