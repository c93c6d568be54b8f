"""Fully Bayesian GP (FBGP): hyperparameter marginalization without MCMC
(port of sober_tpu/gp/fbgp.py; SOBER/FBGP/).

  1. FitboGP: the WSABI square-root-warped base GP,
     g = sign(a) sqrt(2 (a - y)).
  2. RBFHyperPrior: a log-normal hyperprior over theta = (eta_excess,
     noise, lengthscale(s), outputscale) in log space.
  3. fitbo_mll_batch: the FITBO marginal likelihood of every hypersample
     at once. The pairwise squared differences are shared by all thetas;
     each theta's Gram is one contraction and an exp, and its two
     factorizations are batched torch.linalg.cholesky_ex calls with
     torch.linalg.solve_triangular. A lane whose factorization fails
     scores EPS_LML, decided on the device from cholesky_ex's `info`.
  4. quadrature_distillation: kernel recombination (the CAR kernel on the
     card) compresses the weighted hypersamples to n_qd support points,
     in the RKHS of an exp-warped hyper-surrogate GP.
  5. FullyBayesianGP: one conditioned GP per support hypersample
     ("chain"), each with a cached L^-1; a chain's cross-covariance is one
     launch of the RBF kernel with that chain's hypers, and the variance
     reduction of all chains is one batched matmul.

`fbgp_refit` runs 3-5 eagerly, in the order of the JAX package's
fbgp_refit_traced; `Sober.step_fbgp` calls it. The JAX package routes the
sweep's factorizations to a blocked MXU Cholesky on a TPU only
(sober_tpu/ops/blocked_chol.py); everywhere else it takes the plain
factorization, as the port does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device, settings
from ..core.pi import normal_cdf
from ..core.rchq import recombination
from ..ops.rbf_gram import rbf_gram
from ..utils.linalg import remove_anomalies
from ..utils.weights import cleansing_weights, deweighted_resampling
from .exact import (GPConfig, GPState, build_state, fit_gp, fit_params,
                    materialize, pad_observations, predict,
                    predictive_covariance)

EPS_LML = -math.sqrt(float(np.finfo(np.float32).max))
EPS = float(np.finfo(np.float32).eps)


def as_f32(a, device) -> torch.Tensor:
    """`a` as a float32 tensor on `device`."""
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def device_of(x, device=None) -> torch.device:
    """The device of tensor inputs, or `resolve_device(device)` (CUDA
    unless given) for array or list inputs."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def wsabi_warp(eta, y):
    """g = sign(eta) sqrt(2 (eta - y)), clamped at 0 under the root: y
    marginally above eta (rounding, or a padded row when eta < 0) would
    give NaN."""
    return torch.sign(eta) * torch.sqrt(torch.clamp_min(2.0 * (eta - y), 0.0))


# ----------------------------------------------------------------------------
# FitboGP: the WSABI-warped base model (SOBER/FBGP/_fitbo.py)
# ----------------------------------------------------------------------------

class FitboGP:
    """WSABI-L/M square-root-warped GP (SOBER/FBGP/_fitbo.py:7-305).

    `cfg` replaces the fit config that kernel_name, lik, rng, train_lik,
    fit_iters and ard would build (Sober.step_fbgp passes its own)."""

    def __init__(self, x_obs, y_obs, kernel_name: str = "rbf",
                 label: str = "wsabim", alpha_factor: float = 1.0,
                 lik: float = 1e-10, rng: float = 10.0,
                 train_lik: bool = False, optimiser: str = "lbfgs",
                 fit_iters: int = 200, bucket: int = 128,
                 ard: bool = False, cfg: Optional[GPConfig] = None,
                 device=None):
        self.label = label
        self.alpha_factor = alpha_factor
        self.bucket = bucket
        self.jitter = 0.0
        self.cfg = cfg if cfg is not None else GPConfig(
            kernel_name=kernel_name, noise_lo=lik / rng, noise_hi=lik * rng,
            train_lik=train_lik, standardize_y=False, use_priors=False,
            fit_iters=fit_iters, ard=ard)
        self.optimiser = optimiser
        device = device_of(x_obs, device)
        self.Y_unwarp = as_f32(y_obs, device).reshape(-1)
        self._refit(as_f32(x_obs, device), self.Y_unwarp)

    def warp_y(self, y):
        return wsabi_warp(self.alpha, y)

    def unwarp_y(self, y):
        return self.alpha - 0.5 * y ** 2

    def _process_y(self, y, mask=None):
        y = remove_anomalies(y)
        if mask is not None:
            self.alpha = self.alpha_factor * torch.max(
                torch.where(mask > 0, y, -torch.inf))
            # padded rows carry y = 0; with alpha < 0 (all-negative
            # observations) warping them would give NaN, so they are warped
            # at exactly alpha -> 0 before the mask zeroes them
            return self.warp_y(torch.where(mask > 0, y, self.alpha)) * mask
        self.alpha = self.alpha_factor * torch.max(y)
        return self.warp_y(y)

    def _refit(self, x, y_unwarp):
        """Bucket-padded fit: the sweep and the chain caches keep their
        shapes while observations accumulate within a bucket."""
        self.x_obs_raw = x
        xp, yp, mask = pad_observations(x, y_unwarp, self.bucket)
        y_warp = self._process_y(yp, mask)
        self.model: GPState = fit_gp(xp, y_warp, self.cfg,
                                     optimiser=self.optimiser, mask=mask)
        # the padded unwarped targets the FBGP machinery reads
        self.fobs_padded = yp * mask

    def update_wsabi_gp(self, x_new, y_new):
        """(SOBER/FBGP/_fitbo.py:145-164)"""
        dev = self.x_obs_raw.device
        x_all = torch.cat([self.x_obs_raw, as_f32(x_new, dev)])
        self.Y_unwarp = torch.cat([self.Y_unwarp,
                                   as_f32(y_new, dev).reshape(-1)])
        self._refit(x_all, self.Y_unwarp)

    def retrain_gp(self):
        self._refit(self.x_obs_raw, self.Y_unwarp)

    def memorise_parameters(self):
        self._memory = (self.model.kernel, self.model.noise)

    def remind_parameters(self):
        kernel, noise = self._memory
        self.model = self.model._replace(kernel=kernel, noise=noise)

    # warped-space predictions (SOBER/FBGP/_fitbo.py:254-304)
    def wsabil_predict(self, x):
        mu_w, var_w = predict(self.model, x)
        return self.alpha - 0.5 * mu_w ** 2, mu_w * var_w * mu_w

    def wsabim_predict(self, x):
        mu_w, var_w = predict(self.model, x)
        mu = self.alpha - 0.5 * (mu_w ** 2 + var_w)
        var = mu_w * var_w * mu_w + 0.5 * var_w ** 2
        return mu, var

    def predict(self, x):
        return (self.wsabil_predict(x) if self.label == "wsabil"
                else self.wsabim_predict(x))

    def predict_mean(self, x):
        return self.predict(x)[0]

    # warped-space kernels (SOBER/FBGP/_fitbo.py:218-252)
    def _warped_cov(self, x, y):
        """(mu(x) cov(x, y) mu(y), cov(x, y)) of the warped GP."""
        mu_x, _ = predict(self.model, x)
        mu_y, _ = predict(self.model, y)
        cov = predictive_covariance(self.model, x, y)
        return mu_x[:, None] * cov * mu_y[None, :], cov

    def wsabil_kernel(self, x, y):
        return self._warped_cov(x, y)[0]

    def wsabim_kernel(self, x, y):
        k, cov = self._warped_cov(x, y)
        return k + 0.5 * cov ** 2

    def kernel(self, x, y):
        return (self.wsabil_kernel(x, y) if self.label == "wsabil"
                else self.wsabim_kernel(x, y))


# ----------------------------------------------------------------------------
# Hyperprior (SOBER/FBGP/_hyperprior.py)
# ----------------------------------------------------------------------------

class RBFHyperPrior:
    """Log-normal hyperprior over theta = (eta_excess, noise,
    lengthscale(s), outputscale) in log space
    (SOBER/FBGP/_hyperprior.py:6-83). `n_ls` > 1 widens the lengthscale
    block to one entry per input dimension (ARD)."""

    def __init__(self, theta_map=None, n_ls: int = 1, device=None):
        self.n_ls = n_ls
        self.device = resolve_device(device)
        self.initialise(theta_map)

    @property
    def dim(self) -> int:
        return 3 + self.n_ls

    def initialise(self, theta_map=None):
        if theta_map is None:
            mu = [-2.0, 0.1] + [0.1] * self.n_ls + [0.4]
            std = [0.7, 1.0] + [0.7] * self.n_ls + [0.7]
            self.hypermu = as_f32(mu, self.device)
            self.hyperstd = as_f32(std, self.device)
            return
        theta_map = as_f32(theta_map, self.device).reshape(-1)
        if theta_map.shape[0] != self.dim - 1:
            raise ValueError(
                f"theta_map has {theta_map.shape[0]} entries; expected "
                f"{self.dim - 1} = (noise, {self.n_ls} lengthscale(s), "
                "outputscale)")
        self.hypermu = torch.cat([as_f32([-2.0], self.device),
                                  torch.log(theta_map)])
        self.hyperstd = torch.full((self.dim,), 0.1, device=self.device)

    def sample(self, gen: torch.Generator, n_samples: int) -> torch.Tensor:
        z = torch.randn((n_samples, self.dim), generator=gen,
                        device=self.device)
        return self.hypermu[None, :] + z * self.hyperstd[None, :]

    def logpdf(self, theta) -> torch.Tensor:
        z = (theta - self.hypermu[None, :]) / self.hyperstd[None, :]
        return torch.sum(-0.5 * z ** 2 - torch.log(self.hyperstd)[None, :]
                         - 0.5 * math.log(2 * math.pi), dim=1)

    def pdf(self, theta) -> torch.Tensor:
        return torch.exp(self.logpdf(theta))


# ----------------------------------------------------------------------------
# the FITBO marginal likelihood of a batch of hypersamples
# ----------------------------------------------------------------------------

def _fixed_jitter_cholesky(a: torch.Tensor):
    """One fixed-jitter factorization of each matrix of the batch, at
    jitter_cholesky's fp32 floor (1e-6 x its mean diagonal), of the
    symmetrized input as jnp.linalg.cholesky factors it. Returns
    (L, ok): a lane that fails is not retried (its partial factor is
    garbage) and ok is False there; fitbo_mll_batch scores it EPS_LML, as
    the JAX package's NaN factor does."""
    scale = torch.clamp_min(torch.mean(torch.diagonal(a, dim1=-2, dim2=-1),
                                       dim=-1), 1e-30)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    a = 0.5 * (a + a.mT) + (1e-6 * scale)[:, None, None] * eye
    chol, info = torch.linalg.cholesky_ex(a)
    return chol, info == 0


def fitbo_mll_batch(thetas_log: torch.Tensor, x: torch.Tensor,
                    fobs: torch.Tensor, eta: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FITBO marginal log likelihood per datum of each log-space
    hypersample (T, 3 + n_ls) (LogMarginalLikelihood.mll,
    SOBER/FBGP/_fully_Bayesian_gp.py:126-161): the semantics of
    jax.vmap(sober_tpu.gp.fbgp.fitbo_mll). Padded rows (mask 0) contribute
    nothing. Returns (T,), EPS_LML where a factorization failed or the
    value is not finite; nothing is read to the host."""
    big = torch.exp(thetas_log)                            # (T, p)
    t = big.shape[0]
    eta_h = eta + big[:, 0]
    noise, ls, os_ = big[:, 1], big[:, 2:-1], big[:, -1]
    n, d = x.shape
    gobs = wsabi_warp(eta_h[:, None], fobs[None, :])
    # theta-independent pairwise differences: each theta's Gram is one
    # contraction and an exp
    diff2 = (x[:, None, :] - x[None, :, :]) ** 2           # (n, n, d)
    inv_ls2 = (1.0 / ls ** 2).expand(t, d)
    d2 = (inv_ls2 @ diff2.reshape(n * n, d).T).reshape(t, n, n)
    kxx = os_[:, None, None] * torch.exp(-0.5 * d2)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    if mask is not None:
        gobs = gobs * mask[None, :]
        mm = mask[:, None] * mask[None, :]
        kxx = kxx * mm
        noise_diag = noise[:, None, None] * torch.diag(mask)
        kn = kxx + noise_diag + torch.diag(1.0 - mask)
        nreal = torch.sum(mask)
    else:
        noise_diag = noise[:, None, None] * eye
        kn = kxx + noise_diag
        nreal = float(n)
    # the posterior at the training inputs, noise included
    # (SOBER/FBGP/_fully_Bayesian_gp.py:146-151)
    chol, ok = _fixed_jitter_cholesky(kn)
    alpha = torch.cholesky_solve(gobs[:, :, None], chol)
    mu_g = (kxx @ alpha)[:, :, 0]
    v = torch.linalg.solve_triangular(chol, kxx, upper=False)
    cov_g = kxx - v.mT @ v + noise_diag
    var_g = torch.diagonal(cov_g, dim1=-2, dim2=-1)

    mu_f = eta_h[:, None] - 0.5 * (mu_g ** 2 + var_g)
    cov_f = mu_g[:, :, None] * cov_g * mu_g[:, None, :] + 0.5 * cov_g ** 2
    diff = fobs[None, :] - mu_f
    if mask is not None:
        cov_f = cov_f * mm + torch.diag(1.0 - mask)
        diff = diff * mask[None, :]
    chol_f, ok_f = _fixed_jitter_cholesky(cov_f)
    w = torch.linalg.solve_triangular(chol_f, diff[:, :, None],
                                      upper=False)[:, :, 0]
    logdiag = torch.log(torch.diagonal(chol_f, dim1=-2, dim2=-1))
    if mask is not None:
        logdiag = logdiag * mask[None, :]
    ll = (-0.5 * torch.sum(w ** 2, dim=-1) - torch.sum(logdiag, dim=-1)
          - 0.5 * nreal * math.log(2.0 * math.pi))
    mll = ll / nreal
    return torch.where(ok & ok_f & torch.isfinite(mll), mll, EPS_LML)


def fitbo_mll(theta_log: torch.Tensor, x: torch.Tensor, fobs: torch.Tensor,
              eta: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FITBO marginal log likelihood per datum of one log-space
    hypersample (the counterpart of sober_tpu.gp.fbgp.fitbo_mll): the sweep
    at a batch of one. Returns a scalar, EPS_LML where it is not finite."""
    return fitbo_mll_batch(theta_log[None, :], x, fobs, eta, mask)[0]


def _theta_map_of(model: FitboGP, hyperprior: RBFHyperPrior) -> torch.Tensor:
    """The base model's MAP hypers in the hyperprior's layout (noise,
    lengthscale block, outputscale), with the ARD width checked."""
    params = model.model.kernel.params
    if "lengthscale" not in params:
        raise ValueError(
            "FBGP hypersampling needs a lengthscale-bearing kernel; "
            f"{model.model.kernel.name!r} has none")
    ls_map = torch.atleast_1d(params["lengthscale"])
    if ls_map.shape[0] != hyperprior.n_ls:
        raise ValueError(
            f"model lengthscale has {ls_map.shape[0]} dimension(s) but the "
            f"hyperprior was built with n_ls={hyperprior.n_ls}; construct "
            f"RBFHyperPrior(n_ls={ls_map.shape[0]}) for an ARD base model")
    return torch.cat([torch.atleast_1d(model.model.noise), ls_map,
                      torch.atleast_1d(params["outputscale"])])


def sampling_hypers(model: FitboGP, hyperprior: RBFHyperPrior,
                    n_hypers: int = 1000, gen: Optional[torch.Generator] = None,
                    use_map: bool = False):
    """The LML of n_hypers hyperprior draws and of the MAP anchor row
    [-10, log theta_map], in one batched sweep
    (SOBER/FBGP/_fully_Bayesian_gp.py:179-203).

    Returns (hypersamples (n_hypers + 1, p) in ORIGINAL space, LMLs)."""
    x = model.model.x
    eta = model.alpha
    if gen is None:
        gen = torch.Generator(device=x.device).manual_seed(0)
    theta_map = _theta_map_of(model, hyperprior)
    if use_map:
        hyperprior.initialise(theta_map)
    anchor = torch.cat([torch.full((1,), -10.0, device=x.device),
                        torch.log(theta_map)])
    samples = torch.cat([anchor[None, :], hyperprior.sample(gen, n_hypers)])
    lmls = fitbo_mll_batch(samples, x, model.fobs_padded, eta, model.model.mask)
    big = torch.exp(samples)
    # Theta[0] = eta + exp(theta[0])
    # (log_to_exp_transform, SOBER/FBGP/_fully_Bayesian_gp.py:112-124)
    return torch.cat([eta + big[:, :1], big[:, 1:]], dim=1), lmls


# ----------------------------------------------------------------------------
# the exp-warped hyper-surrogate and the distillation (SOBER/FBGP/_scale_vbq.py)
# ----------------------------------------------------------------------------

# The hyper-surrogate's MAP fit sees this many hypersamples (iid draws, so a
# prefix is an unbiased subsample; row 0, the MAP anchor, is always in it).
# Its only consumer is its prior kernel as the recombination RKHS.
_SURROGATE_FIT_N = 128

# ScaleVanillaGP's defaults: rbf, noise in [1e-11, 1e-9], no y
# standardization (also FitboGP's and Sober.step_fbgp's default config)
_VBQ_CFG = GPConfig(kernel_name="rbf", noise_lo=1e-11, noise_hi=1e-9,
                    train_lik=False, standardize_y=False, use_priors=False,
                    fit_iters=200)


def _surrogate_params(x_obs, y, cfg: GPConfig, optimiser: str,
                      fit_n: Optional[int]):
    """MAP hypers of the exp-warped surrogate on the first fit_n rows (all
    when None), their targets exp(y - max) normalized within that prefix:
    a global normalization degrades to all-near-zero targets whenever the
    argmax lies outside the prefix, and only shifts the outputscale, to
    which recombination's globally normalized moments are invariant."""
    n_fit = x_obs.shape[0] if fit_n is None else min(fit_n, x_obs.shape[0])
    y_fit = y[:n_fit]
    return fit_params(x_obs[:n_fit], torch.exp(y_fit - torch.max(y_fit)), cfg,
                      optimiser=optimiser)


class ScaleVanillaGP:
    """exp-warped vanilla GP on log-likelihood observations
    (SOBER/FBGP/_scale_vbq.py:7-171). `fit_n` caps the rows the MAP fit
    sees; the state conditions on all rows, with targets exp(y - max y)
    normalized over all of them, as the JAX package builds it."""

    def __init__(self, x_obs, y_log, kernel_name: str = "rbf",
                 lik: float = 1e-10, rng: float = 10.0,
                 train_lik: bool = False, optimiser: str = "lbfgs",
                 fit_iters: int = 200, fit_n: int | None = None,
                 device=None):
        self.cfg = GPConfig(
            kernel_name=kernel_name, noise_lo=lik / rng, noise_hi=lik * rng,
            train_lik=train_lik, standardize_y=False, use_priors=False,
            fit_iters=fit_iters)
        self.optimiser = optimiser
        self.jitter = 1e-6
        device = device_of(x_obs, device)
        x_obs = as_f32(x_obs, device)
        self.y_log = as_f32(y_log, device).reshape(-1)
        y = remove_anomalies(self.y_log)
        self.beta = torch.max(y)
        params = _surrogate_params(x_obs, y, self.cfg, optimiser, fit_n)
        self.model: GPState = build_state(params, x_obs, torch.exp(y - self.beta),
                                          self.cfg)

    def predict(self, x):
        return predict(self.model, x)

    def predict_mean(self, x):
        return predict(self.model, x)[0]

    def predictive_kernel(self, x, y):
        return predictive_covariance(self.model, x, y)

    def prior_kernel(self, x, y):
        return self.model.kernel.gram(x, y)


def _nystrom_with_top(gen: torch.Generator, hypersamples: torch.Tensor,
                      weights: torch.Tensor, n_nys: int) -> torch.Tensor:
    """Nystrom test points: inverse-weight resampling for coverage, plus the
    top-weighted hypersamples pinned in. The FITBO hyperposterior is often
    concentrated on a couple of hypersamples (ESS ~ 2); without them among
    the test functions, recombination drops nearly all the posterior
    mass."""
    n_top = min(8, n_nys // 2)
    idx_nys = deweighted_resampling(gen, weights, n_nys - n_top)
    if n_top == 0:
        return hypersamples[idx_nys]
    top = torch.argsort(weights, stable=True)[-n_top:]
    return torch.cat([hypersamples[top], hypersamples[idx_nys]])


def quadrature_distillation(hypersamples: torch.Tensor, lmls: torch.Tensor,
                            n_nys: int = 100, n_qd: int = 50,
                            gen: Optional[torch.Generator] = None):
    """Compress the LML-weighted hypersamples to n_qd support points by
    kernel recombination in the RKHS of the hyper-surrogate's prior kernel
    (SOBER/FBGP/_fully_Bayesian_gp.py:205-245). The surrogate is fitted as
    ScaleVanillaGP(hypersamples, lmls, fit_n=128) fits it, and only its
    kernel is built. Returns (w_qd, Theta_qd)."""
    if gen is None:
        gen = torch.Generator(device=hypersamples.device).manual_seed(1)
    weights = cleansing_weights(torch.exp(lmls - torch.max(lmls)))
    hyper_nys = _nystrom_with_top(gen, hypersamples, weights, n_nys)
    params = _surrogate_params(hypersamples, remove_anomalies(lmls), _VBQ_CFG,
                               "lbfgs", _SURROGATE_FIT_N)
    kernel, _ = materialize(params, _VBQ_CFG)
    idx, w_qd = recombination(hypersamples, hyper_nys, n_qd, kernel.gram,
                              init_weights=weights)
    return w_qd, hypersamples[idx]


# ----------------------------------------------------------------------------
# the chain caches and the refit
# ----------------------------------------------------------------------------

class ChainCache(NamedTuple):
    # (q, n, n) explicit L^-1 of each chain's K + noise: every consumer
    # solves against it with a pool-wide right-hand side, which is then a
    # batched matmul
    linv: torch.Tensor
    alpha: torch.Tensor   # (q, n)


def _chain_params(theta: torch.Tensor) -> dict:
    """One chain's RBF hypers from its ORIGINAL-space theta row."""
    return {"lengthscale": theta[2:-1], "outputscale": theta[-1]}


def _chain_grams(theta_qd: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """(q, |x|, |y|) RBF Grams, one kernel launch per chain with its
    lengthscale and outputscale."""
    return torch.stack([rbf_gram(_chain_params(th), x, y) for th in theta_qd])


def _batched_jitter_cholesky(a: torch.Tensor) -> torch.Tensor:
    """jitter_cholesky of each matrix of the batch, each on its own ladder
    (as jax.vmap runs the JAX package's): a failing matrix retries at 10x
    its jitter while the others keep their factor, at most max_psd_iter
    times, then falls back to its diagonal. One host read a rung."""
    a = torch.nan_to_num(a)
    a = 0.5 * (a + a.mT)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    scale = torch.clamp_min(torch.mean(torch.abs(diag), dim=-1), 1e-30)
    jit = 1e-6 * scale

    def attempt(jit):
        chol, info = torch.linalg.cholesky_ex(a + jit[:, None, None] * eye)
        return chol, (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))

    chol, bad = attempt(jit)
    for _ in range(settings().max_psd_iter):
        if not bool(bad.any()):
            break
        jit = torch.where(bad, torch.where(jit == 0, 1e-6 * scale, 10.0 * jit),
                          jit)
        retry, still = attempt(jit)
        chol = torch.where(bad[:, None, None], retry, chol)
        bad = bad & still
    fallback = torch.diag_embed(torch.sqrt(torch.clamp_min(diag, 1e-30)))
    return torch.where(bad[:, None, None], fallback, chol)


def chain_caches(theta_qd: torch.Tensor, x: torch.Tensor, fobs: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> ChainCache:
    """Each chain's conditioning cache: L^-1 of K + noise and alpha on the
    WSABI-warped targets, batched over the chains."""
    noise = theta_qd[:, 1]
    gobs = wsabi_warp(theta_qd[:, :1], fobs[None, :])
    kxx = _chain_grams(theta_qd, x, x)
    n = x.shape[0]
    if mask is not None:
        gobs = gobs * mask[None, :]
        kn = (kxx * (mask[:, None] * mask[None, :])
              + noise[:, None, None] * torch.diag(mask) + torch.diag(1.0 - mask))
    else:
        kn = kxx + noise[:, None, None] * torch.eye(n, dtype=x.dtype,
                                                    device=x.device)
    chol = _batched_jitter_cholesky(kn)
    alpha = torch.cholesky_solve(gobs[:, :, None], chol)[:, :, 0]
    eye = torch.eye(n, dtype=x.dtype, device=x.device).expand_as(chol)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return ChainCache(linv, alpha)


def fbgp_refit(model: FitboGP, hyperprior: RBFHyperPrior,
               n_hypers: int = 1000, n_nys: int = 100, n_qd: int = 50,
               gen: Optional[torch.Generator] = None,
               use_map: bool = False) -> "FullyBayesianGP":
    """The hyper pipeline: the LML sweep over n_hypers draws and the MAP
    anchor -> the LML-weighted Nystrom subset -> the hyper-surrogate's MAP
    fit -> recombination to n_qd chains -> the chain caches, in the order
    of sober_tpu/gp/fbgp.py:fbgp_refit_traced. `gen` (a generator on the
    model's device) feeds the hyperprior draw and the Nystrom subset."""
    x = model.model.x
    if gen is None:
        gen = torch.Generator(device=x.device).manual_seed(0)
    hypersamples, lmls = sampling_hypers(model, hyperprior, n_hypers, gen,
                                         use_map)
    w_qd, theta_qd = quadrature_distillation(hypersamples, lmls, n_nys, n_qd,
                                             gen)
    cache = chain_caches(theta_qd, x, model.fobs_padded, model.model.mask)
    return FullyBayesianGP(model, w_qd, theta_qd, cache=cache)


# ----------------------------------------------------------------------------
# FullyBayesianGP (SOBER/FBGP/_fully_Bayesian_gp.py:247-371)
# ----------------------------------------------------------------------------

class FullyBayesianGP:
    """Distilled-hyperposterior GP: predictions marginalized over n_qd
    hypersample chains, each with a cached L^-1."""

    is_fbgp = True

    def __init__(self, gp: FitboGP, w_qd, theta_qd, cache: Optional[ChainCache] = None):
        self.Xobs = gp.model.x
        self.fobs = gp.fobs_padded
        self.mask = gp.model.mask
        self.eta = gp.alpha
        self.w_qd = as_f32(w_qd, self.Xobs.device)
        self.Theta_qd = as_f32(theta_qd, self.Xobs.device)  # ORIGINAL space
        self._cache = cache if cache is not None else chain_caches(
            self.Theta_qd, self.Xobs, self.fobs, self.mask)

    @classmethod
    def from_arrays(cls, x_obs, fobs, mask, eta, w_qd, theta_qd,
                    cache: ChainCache) -> "FullyBayesianGP":
        """Rebuild from its tensors, with no FitboGP."""
        obj = object.__new__(cls)
        obj.Xobs, obj.fobs, obj.mask, obj.eta = x_obs, fobs, mask, eta
        obj.w_qd, obj.Theta_qd, obj._cache = w_qd, theta_qd, cache
        return obj

    def fitbo_predict(self, x_test: torch.Tensor, theta: torch.Tensor,
                      linv: torch.Tensor, alpha: torch.Tensor):
        """The f-space posterior mean and variance at x_test of one chain
        (theta (p,), linv (n, n), alpha (n,); returns (m,) each) or of a
        stack of chains (theta (q, p), linv (q, n, n), alpha (q, n); returns
        (q, m) each) (fitbo_predict, SOBER/FBGP/_fully_Bayesian_gp.py:
        262-289). `linv` is the chain's cached L^-1, so the variance
        reduction is one matmul; K(x, X_obs) is one RBF launch a chain."""
        one = theta.dim() == 1
        if one:
            theta, linv, alpha = theta[None], linv[None], alpha[None]
        eta_h, noise, os_ = theta[:, 0], theta[:, 1], theta[:, -1]
        kqx = _chain_grams(theta, x_test, self.Xobs)       # (q, m, n)
        if self.mask is not None:
            kqx = kqx * self.mask
        mu_g = (kqx @ alpha[:, :, None])[:, :, 0]
        v = linv @ kqx.mT                                  # (q, n, m)
        var_g = (torch.clamp_min(os_[:, None] - torch.sum(v * v, dim=1), 0.0)
                 + noise[:, None])
        mu_f = eta_h[:, None] - 0.5 * (mu_g ** 2 + var_g)
        var_f = torch.clamp_min(mu_g * var_g * mu_g + 0.5 * var_g ** 2, 0.0)
        return (mu_f[0], var_f[0]) if one else (mu_f, var_f)

    def batch_predict(self, x_test: torch.Tensor):
        """(q, m) f-space posterior mean and variance of each chain
        (SOBER/FBGP/_fully_Bayesian_gp.py:307-323): fitbo_predict over the
        stack of chains, with one batched matmul for all the chains'
        variance reductions."""
        return self.fitbo_predict(x_test, self.Theta_qd, self._cache.linv,
                                  self._cache.alpha)

    def marginal_predict(self, x_test):
        """(SOBER/FBGP/_fully_Bayesian_gp.py:325-339)"""
        mu_b, var_b = self.batch_predict(x_test)
        mu = self.w_qd @ mu_b
        return mu, self.w_qd @ (var_b + mu_b ** 2) - mu ** 2

    def marginal_predictive_mean(self, x_test):
        return self.w_qd @ self.batch_predict(x_test)[0]

    def marginal_predictive_covariance(self, x_test, y_test):
        """Weighted sample covariance of the chain means
        (SOBER/FBGP/_fully_Bayesian_gp.py:354-371); the recombination
        kernel of Sober with this model."""
        mu_x = self.batch_predict(x_test)[0]
        mu_y = mu_x if y_test is x_test else self.batch_predict(y_test)[0]
        w = self.w_qd
        w_corr = 1.0 / torch.clamp_min(1.0 - torch.sum(w ** 2), 1e-6)
        cx = mu_x - (w @ mu_x)[None, :]
        cy = mu_y - (w @ mu_y)[None, :]
        return w_corr * (w[:, None] * cx).T @ cy

    def make_pi(self):
        return PIFBGP(self)

    def rc_kernel(self):
        return self.marginal_predictive_covariance


class PIFBGP:
    """Hyperposterior-weighted LFI pi (PI_FBGP, SOBER/_pi.py:58-107):
    sum_i w_i Phi((mu_i - eta_i) / sigma_i), Phi keeping its float32
    lower tail (core/pi.py:normal_cdf)."""

    def __init__(self, model: FullyBayesianGP, label: str = "lfi"):
        self.model = model
        self.label = label

    def __call__(self, x_cand, log: bool = False):
        m = self.model
        mu_b, var_b = m.batch_predict(x_cand)
        z = (mu_b - m.Theta_qd[:, 0][:, None]) / torch.sqrt(
            torch.clamp_min(var_b, 1e-30))
        val = m.w_qd @ normal_cdf(z)
        return torch.log(val + EPS) if log else val


def _acq_ei(m: FullyBayesianGP, mu_b, var_b):
    eta = m.Theta_qd[:, 0][:, None]
    sd = torch.sqrt(torch.clamp_min(var_b, 1e-30))
    z = (mu_b - eta) / sd
    pdf = torch.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return m.w_qd @ ((mu_b - eta) * normal_cdf(z) + sd * pdf)


def _marginal(m: FullyBayesianGP, mu_b, var_b):
    ey = m.w_qd @ mu_b
    return ey, m.w_qd @ (var_b + mu_b ** 2) - ey ** 2


def _acq_ucb(m, mu_b, var_b):
    ey, vy = _marginal(m, mu_b, var_b)
    return ey + torch.sqrt(torch.clamp_min(vy, 0.0))


def _acq_mes(m, mu_b, var_b):
    _, vary = _marginal(m, mu_b, var_b)
    two_pi_e = 2.0 * math.pi * math.e
    noise = m.Theta_qd[:, 1]
    h1 = 0.5 * torch.log(two_pi_e * (vary + m.w_qd @ noise))
    h2 = 0.5 * (m.w_qd @ torch.log(two_pi_e * (var_b + noise[:, None])))
    return h1 - h2


def _acq_bqbc(m, mu_b, var_b):
    ey = m.w_qd @ mu_b
    return m.w_qd @ (mu_b - ey[None, :])


def _acq_qbmgp(m, mu_b, var_b):
    ey, vy = _marginal(m, mu_b, var_b)
    return vy + m.w_qd @ (mu_b - ey[None, :])


class FBGPAcquisitionFunction:
    """EI / UCB / MES (FITBO) / BQBC / QBMGP over hyperposterior-weighted
    chain predictions (SOBER/FBGP/_acquisition_function.py:5-117); a
    calc_obj for Sober.next_batch."""

    LABELS = ("EI", "UCB", "MES", "BQBC", "QBMGP")
    _APPLIES = {"EI": _acq_ei, "UCB": _acq_ucb, "MES": _acq_mes,
                "BQBC": _acq_bqbc, "QBMGP": _acq_qbmgp}

    def __init__(self, model: FullyBayesianGP, label: str = "MES"):
        if label not in self.LABELS:
            raise ValueError(
                f"Acquisition function type should be from {self.LABELS}")
        self.model = model
        self.label = label

    def __call__(self, x):
        return self._APPLIES[self.label](self.model,
                                         *self.model.batch_predict(x))
