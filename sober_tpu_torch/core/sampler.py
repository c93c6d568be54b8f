"""Importance sampler: pi-weighted candidate pools and kernel recombination
(port of sober_tpu/core/sampler.py; SOBER/_sampler.py).

Two domains are ported. Dataset: pi over the whole (masked) pool, static
top-k pruning and an inverse-weight Nystrom subset. Continuous: a Uniform
(Sobol), Gaussian or learned WKDE proposal, the proposal refit, refill
draws and a KMeans Nystrom subset. Each runs as one eager pipeline: the
dataset one in core/fused_sampling.py, the continuous one in
`sampling_candidates`, built from `sampling`, `recursive_sampling`,
`update_prior` and `_select_nys`. The discrete and mixed domains wait for ROADMAP.md queue 1,
item 10, the TruncatedGaussian proposal for item 13, and the JAX package's
`mesh`/`schedule` arguments for item 16.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..priors.base import BasePrior
from ..priors.continuous import Gaussian, Uniform
from ..priors.wkde import WeightedKernelDensityEstimation
from ..utils.prng import KeyRing
from ..utils.weights import check_weights, deweighted_resampling
from . import fused_sampling as fs
from .prior_update import update_continuous_prior
from .rchq import recombination

# the continuous proposals the pipeline takes
CONTINUOUS = (Uniform, Gaussian, WeightedKernelDensityEstimation)

# dataset-domain pruning threshold (SOBER/_sampler.py:325-349)
PRUNE_THRESH = 1e-3


class RecombinationSampler:
    """Kernel recombination step (SOBER/_sampler.py:11-59)."""

    def __init__(self, kernel: Callable, thresh: int = 5, seed: int = 0,
                 device=None):
        self.kernel = kernel
        self.thresh = thresh
        self.keys = KeyRing(seed, device=device)
        # count of positive pool weights of the last iteration (a device
        # scalar, read lazily) and which path produced the batch
        self.last_npos = None
        self.last_path = None

    def sampling_recombination(self, x_cand, x_nys, weights, batch_size,
                               calc_obj=None):
        return recombination(x_cand, x_nys, batch_size, self.kernel,
                             init_weights=weights, calc_obj=calc_obj)


class EmpiricalSampler(RecombinationSampler):
    """pi-importance sampling pipeline (SOBER/_sampler.py:61-382), for a
    dataset or continuous prior."""

    def __init__(self, prior: BasePrior, pi, kernel: Callable,
                 thresh: int = 5, label: str = "mixedbinary", seed: int = 0):
        if label == "continuous" and not isinstance(prior, CONTINUOUS):
            raise NotImplementedError(
                f"continuous prior {type(prior).__name__}: the Uniform, "
                "Gaussian and WKDE proposals are ported; TruncatedGaussian "
                "is ROADMAP.md queue 1, item 13")
        if label not in ("dataset", "continuous"):
            raise NotImplementedError(
                f"domain label {label!r}: the dataset and continuous domains "
                "are ported; the discrete and mixed samplers are ROADMAP.md "
                "queue 1, item 10")
        super().__init__(kernel, thresh=thresh, seed=seed,
                         device=getattr(prior, "device", None))
        self.thresh_initial = thresh
        self.prior = prior
        self.prior_initial = prior
        self.pi = pi
        self.label = label
        self.flag = False
        # host reads of the last continuous candidate pipeline
        self.last_reads = 0

    # -- proposal management (continuous) -------------------------------------

    def initialise_prior(self):
        """Reset the proposal to the original domain prior
        (SOBER/_sampler.py:87-111): a fresh Uniform over the original box
        (its Sobol sequence from offset 0), or the original bounds-less
        Gaussian itself."""
        p = self.prior_initial
        bounds = getattr(p, "bounds", None)
        self.prior = p if bounds is None else Uniform(bounds, device=bounds.device)

    def update_prior(self, x_cand, weights):
        """Refit the proposal to the weighted pool as a WKDE of at most 4096
        components (SOBER/_sampler.py:113-157); a Gaussian's WKDE has no
        bounds."""
        self.prior = update_continuous_prior(
            x_cand, weights, self.prior, self.prior.n_dims, gen=self.keys.next())

    def sampling(self, n_rec: int, redraw: bool = False):
        """One pool draw: X ~ proposal, w = cleanse(pi(X) / p(X))
        (SOBER/_sampler.py:173-187). A redraw from a Uniform is pseudo-
        random, as the JAX pipeline's refill draws are; only the first
        draw follows (and advances) its Sobol sequence."""
        p, gen = self.prior, self.keys.next()
        if redraw and isinstance(p, Uniform):
            x = p.scale(torch.rand((n_rec, p.n_dims), generator=gen,
                                   device=p.device))
        else:
            x = p.sample(gen, n_rec)
        return x, fs.pi_weights(self.pi, x, p.pdf(x))

    def recursive_sampling(self, n_rec: int, n_repeat: int = 5,
                           need: int | None = None):
        """A fresh pool whose zero-weight rows are refilled by up to
        n_repeat - 1 redraws while at most `need` (self.thresh) rows are
        accepted (SOBER/_sampler.py:205-261); uniform weights, and
        self.flag set, when nothing is ever accepted. Adds its host reads
        (one accepted count a round) to self.last_reads."""
        draw = lambda: self.sampling(n_rec, redraw=True)
        x, w, self.flag, reads = fs.refill(
            draw, *draw(), self.thresh if need is None else need, n_repeat)
        self.last_reads += reads
        return x, w

    def _select_nys(self, x_cand, weights, n_nys: int):
        """Nystrom subset: KMeans centroids for continuous domains, inverse-
        weight resampling otherwise (SOBER/_sampler.py:316-320)."""
        if self.label == "continuous":
            return fs.select_nys(self.keys.next(), x_cand, weights, n_nys)
        return x_cand[deweighted_resampling(self.keys.next(), weights, n_nys)]

    def sampling_candidates(self, n_rec: int, n_nys: int):
        """The continuous pipeline (fused_sampling.py:_uniform_pipeline,
        _wkde_pipeline, _gauss_pipeline and _cont_branches of the JAX
        package): a pool from the proposal; if its weights are healthy (at
        least thresh distinct values), a WKDE refit on them; else the old
        proposal refilled for up to thresh rounds first and the WKDE fit on
        that, unless nothing was accepted: then the uniform-weight pool and
        its first n_nys rows are returned and the proposal stays. The
        WKDE's pool is refilled for up to n_nys rounds and sparsified by
        KMeans. Returns (x_cand, x_nys, weights).

        Host reads: the weight-health branch and one count a refill round
        (self.last_reads); the JAX program reads nothing, but its host
        reads the Uniform/Gaussian -> WKDE switch once."""
        if n_rec <= n_nys:
            raise ValueError(f"n_rec={n_rec} must exceed n_nys={n_nys}")
        self.last_reads = 1
        x, w = self.sampling(n_rec)
        if not bool(check_weights(w, self.thresh_initial)):
            x, w = self.recursive_sampling(n_rec, self.thresh_initial,
                                           need=self.thresh_initial)
            if self.flag:
                return x, x[:n_nys], w
        self.update_prior(x, w)
        x, w = self.recursive_sampling(n_rec, n_nys, need=n_nys)
        return x, self._select_nys(x, w, n_nys), w

    # -- dataset domains -------------------------------------------------------

    def adaptive_pruning(self, weights, n_rec: int, n_nys: int,
                         thresh: float = PRUNE_THRESH):
        """Static top-k pruning: see fused_sampling.adaptive_pruning."""
        return fs.adaptive_pruning(weights, n_rec, n_nys, thresh)

    def sampling_datasets(self, n_rec: int, n_nys: int,
                          dataset_pruning: bool = True):
        """pi over the whole dataset -> prune -> Nystrom subset
        (SOBER/_sampler.py:351-382). Returns (idx_sampled, X_cand, X_nys,
        weights); idx_sampled maps pool rows to dataset rows."""
        if n_rec <= n_nys:
            raise ValueError(f"n_rec={n_rec} must exceed n_nys={n_nys}")
        x_all = self.prior.available_candidates()
        return fs.dataset_candidates(
            self.pi(x_all), x_all, self.prior.available_mask(),
            self.keys.next(), n_rec, n_nys, PRUNE_THRESH, dataset_pruning)

    def _fused_dataset_iteration(self, n_rec: int, n_nys: int, batch: int,
                                 prune: bool, calc_obj=None):
        """pi sweep + pruning + Nystrom subset + recombination. Returns
        (idx_global, x_batch, w_rchq)."""
        idx_global, x_batch, w_rchq, self.last_npos = (
            fs.fused_iteration_dataset(
                self.pi, self.prior.available_candidates(),
                self.prior.available_mask(), self.keys.next(), self.kernel,
                n_rec=n_rec, n_nys=n_nys, thresh=PRUNE_THRESH, batch=batch,
                prune=prune, calc_obj=calc_obj))
        return idx_global, x_batch, w_rchq
