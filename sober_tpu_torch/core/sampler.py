"""Importance sampler: pi-weighted candidate pools and kernel recombination
(port of sober_tpu/core/sampler.py; SOBER/_sampler.py).

Every domain label of the JAX package is ported. Dataset: pi over the
whole (masked) pool, static top-k pruning and an inverse-weight Nystrom
subset (core/fused_sampling.py). Continuous (a Uniform, Gaussian,
TruncatedGaussian or WKDE proposal), binary, categorical,
mixedbinary and mixedcategorical: a pool from the proposal, the proposal
refit, refill draws and a Nystrom subset, as one eager pipeline,
`sampling_candidates`, built from `sampling` (or `categorical_sampling`),
`recursive_sampling`, `update_prior` and `_select_nys`. `MixtureSampler`
draws from a Sober's learned proposal mixed with the prior (BASQ's
posterior sampling). The JAX package's `mesh`/`schedule` arguments wait
for ROADMAP.md queue 1, item 16.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..priors.base import BasePrior
from ..priors.continuous import Gaussian, TruncatedGaussian, Uniform
from ..priors.discrete import (BinaryPrior, CategoricalPrior,
                               MixedBinaryPrior, MixedCategoricalPrior)
from ..priors.wkde import WeightedKernelDensityEstimation
from ..utils.prng import KeyRing
from ..utils.weights import check_weights, deweighted_resampling
from . import fused_sampling as fs
from .prior_update import (update_binary_prior, update_categorical_prior,
                           update_continuous_prior, update_mixed_prior)
from .rchq import recombination

# the continuous proposals the pipeline takes
CONTINUOUS = (Uniform, Gaussian, TruncatedGaussian, WeightedKernelDensityEstimation)
LABELS = ("dataset", "continuous", "binary", "categorical", "mixedbinary",
          "mixedcategorical")

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
    """pi-importance sampling pipeline (SOBER/_sampler.py:61-382)."""

    def __init__(self, prior: BasePrior, pi, kernel: Callable,
                 thresh: int = 5, label: str = "mixedbinary", seed: int = 0):
        if label == "continuous" and not isinstance(prior, CONTINUOUS):
            raise TypeError(
                f"continuous prior {type(prior).__name__}: the proposals are "
                "Uniform, Gaussian, TruncatedGaussian and WKDE")
        if label not in LABELS:
            raise ValueError(f"domain label {label!r} is not one of {LABELS}")
        super().__init__(kernel, thresh=thresh, seed=seed,
                         device=getattr(prior, "device", None))
        self.thresh_initial = thresh
        self.prior = prior
        self.prior_initial = prior
        self.pi = pi
        self.label = label
        self.flag = False
        # host reads of the last candidate pipeline
        self.last_reads = 0

    # -- proposal management ---------------------------------------------------

    def initialise_prior(self):
        """Reset the proposal to the original domain prior
        (SOBER/_sampler.py:87-111), rebuilt from the original's attributes:
        a fresh Uniform over the original box (its Sobol sequence from
        offset 0; a TruncatedGaussian's box too) or the original
        bounds-less Gaussian itself; fresh 0.5 Bernoulli or categorical
        masses; a fresh mixed prior."""
        p, label = self.prior_initial, self.label
        dev = p.device
        if label == "continuous":
            bounds = getattr(p, "bounds", None)
            self.prior = p if bounds is None else Uniform(bounds, device=dev)
        elif label == "binary":
            self.prior = BinaryPrior(p.n_dims, device=dev)
        elif label == "categorical":
            self.prior = CategoricalPrior(p.categories, device=dev)
        elif label == "mixedbinary":
            self.prior = MixedBinaryPrior(p.n_dims_cont, p.n_dims_binary, p.bounds,
                                          p.continous_first, device=dev)
        elif label == "mixedcategorical":
            self.prior = MixedCategoricalPrior(p.n_dims_cont, p.n_dims_disc,
                                               p.categories, p.bounds,
                                               p.continous_first, device=dev)

    def update_prior(self, x_cand, weights):
        """Fit the proposal to the weighted pool (SOBER/_sampler.py:113-157):
        a continuous proposal as a WKDE of at most 4096 components, bounded
        by the proposal's box (a Gaussian's WKDE has none), a Bernoulli or
        categorical one by its MLE, a mixed one block by block. For the categorical labels
        x_cand holds category indices in the discrete block."""
        label = self.label
        if label == "continuous":
            self.prior = update_continuous_prior(
                x_cand, weights, self.prior, self.prior.n_dims, gen=self.keys.next())
        elif label == "binary":
            self.prior = update_binary_prior(weights, x_cand, self.prior)
        elif label == "categorical":
            self.prior = update_categorical_prior(weights, x_cand, self.prior)
        else:
            self.prior = update_mixed_prior(x_cand, weights, self.prior,
                                            label=label[len("mixed"):],
                                            gen=self.keys.next())

    def check_categorical(self) -> bool:
        return self.label in ("categorical", "mixedcategorical")

    def sampling(self, n_rec: int, redraw: bool = False):
        """One pool draw: X ~ proposal, w = cleanse(pi(X) / p(X))
        (SOBER/_sampler.py:173-187). A redraw from a Uniform (or a mixed
        prior's Uniform block) is pseudo-random, as the JAX pipeline's
        refill draws are; only the first draw follows (and advances) its
        Sobol sequence."""
        x, _, pdf = fs.draw(self.prior, self.label, self.keys.next(), n_rec, redraw)
        return x, fs.pi_weights(self.pi, x, pdf)

    def categorical_sampling(self, n_rec: int, redraw: bool = False):
        """A pool draw that also returns the rows with category indices in
        the discrete block, which the categorical update reads
        (SOBER/_sampler.py:189-203): (X, X_indices, w)."""
        x, xi, pdf = fs.draw(self.prior, self.label, self.keys.next(), n_rec, redraw)
        return x, xi, fs.pi_weights(self.pi, x, pdf)

    def _draw(self, n_rec: int, redraw: bool = False):
        """A pool as the refill carries it: for the categorical labels the
        values and then the index rows side by side, so that every filled
        row replaces both."""
        if self.check_categorical():
            x, xi, w = self.categorical_sampling(n_rec, redraw)
            return torch.cat([x, xi], dim=1), w
        return self.sampling(n_rec, redraw)

    def _split(self, x):
        """(values,), or (values, index rows) for the categorical labels, of
        a pool as `_draw` carries it."""
        if self.check_categorical():
            # the kernels take contiguous operands
            n = self.prior.n_dims
            return x[:, :n].contiguous(), x[:, n:]
        return (x,)

    def recursive_sampling(self, n_rec: int, n_repeat: int = 5,
                           need: int | None = None):
        """A fresh pool whose zero-weight rows are refilled by up to
        n_repeat - 1 redraws while at most `need` (self.thresh) rows are
        accepted (SOBER/_sampler.py:205-261); uniform weights, and
        self.flag set, when nothing is ever accepted. Returns (x, w), or
        (x, x_indices, w) for the categorical labels. Adds its host reads
        (one accepted count a round) to self.last_reads."""
        draw = lambda: self._draw(n_rec, redraw=True)
        x, w, self.flag, reads = fs.refill(
            draw, *draw(), self.thresh if need is None else need, n_repeat)
        self.last_reads += reads
        return *self._split(x), w

    def _select_nys(self, x_cand, weights, n_nys: int):
        """Nystrom subset: KMeans centroids for continuous domains, inverse-
        weight resampling otherwise (SOBER/_sampler.py:316-320)."""
        if self.label == "continuous":
            return fs.select_nys(self.keys.next(), x_cand, weights, n_nys)
        return x_cand[deweighted_resampling(self.keys.next(), weights, n_nys)]

    def sampling_candidates(self, n_rec: int, n_nys: int):
        """The candidate pipeline of every non-dataset label (the JAX
        package's fused_sampling.py:_cont_branches, shared by its uniform,
        WKDE, Gaussian, binary and spec-driven discrete pipelines): a pool
        from the proposal; if its weights are healthy (at least thresh
        distinct values), the proposal update on them; else the old
        proposal refilled for up to thresh rounds first and the update fit
        on that, unless nothing was accepted: then the uniform-weight pool
        and its first n_nys rows are returned and the proposal stays. The
        updated proposal's pool is refilled for up to n_nys rounds and
        sparsified (`_select_nys`). A Uniform block becomes a WKDE at its
        first update. Returns (x_cand, x_nys, weights), x_cand the values.

        Host reads: the weight-health branch and one count a refill round
        (self.last_reads); the JAX program reads nothing, but its host
        reads the Uniform/Gaussian -> WKDE switch once."""
        if n_rec <= n_nys:
            raise ValueError(f"n_rec={n_rec} must exceed n_nys={n_nys}")
        self.last_reads = 1
        x, w = self._draw(n_rec)
        xs = self._split(x)
        if not bool(check_weights(w, self.thresh_initial)):
            *xs, w = self.recursive_sampling(n_rec, self.thresh_initial,
                                             need=self.thresh_initial)
            if self.flag:
                return xs[0], xs[0][:n_nys], w
        # the categorical updates read the index rows
        self.update_prior(xs[-1], w)
        x, *_, w = self.recursive_sampling(n_rec, n_nys, need=n_nys)
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


class MixtureSampler:
    """The learned proposal of a Sober (a WKDE once it has been updated)
    mixed with the prior, for posterior SIR sampling
    (SOBER/_sampler.py:384-447)."""

    def __init__(self, prior: BasePrior, sober, ratio_wkde: float = 0.5):
        self.prior = prior
        self.sober = sober
        self.bounds = getattr(prior, "bounds", None)
        self.ratio_wkde = ratio_wkde

    def sample(self, gen: torch.Generator, n_samples: int) -> torch.Tensor:
        """int(ratio_wkde * n) rows from the proposal, the rest from the
        prior, both drawn with `gen`."""
        n_wkde = int(self.ratio_wkde * n_samples)
        parts = []
        if n_wkde:
            parts.append(self.sober.prior.sample(gen, n_wkde))
        if n_samples - n_wkde:
            parts.append(self.prior.sample(gen, n_samples - n_wkde))
        return torch.cat(parts, dim=0)

    def pdf(self, x: torch.Tensor) -> torch.Tensor:
        return (self.ratio_wkde * self.sober.prior.pdf(x)
                + (1.0 - self.ratio_wkde) * self.prior.pdf(x))
