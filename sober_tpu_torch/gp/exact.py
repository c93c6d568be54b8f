"""Exact Gaussian-process regression with an explicit Cholesky cache
(port of sober_tpu/gp/exact.py).

GPState is a NamedTuple of tensors (hypers, data, the cached factor of
Kxx + sigma^2 I, alpha and its explicit inverse L^-1). Hypers are MAP-fitted
by an L-BFGS ladder that falls back to Adam. The fit runs eagerly, with
Python control flow where the JAX package had lax.scan and lax.cond, and
host syncs where a branch needs a value. Everything after the fit reaches
the RBF and Tanimoto Grams through their CUDA kernels; so does the fit's
Tanimoto Gram, whose inputs never need a gradient. The exploit polish
(`polish_posterior_mean`) differentiates the posterior mean in its inputs,
through the RBF kernel's autograd Function.

The prior mean is zero, or BOLFI's per-dimension parabola
m(x) = sum_j a_j x_j^2 + b_j x_j + c (`mean="parabolic"`), whose
parameters ride in `GPParams.mean_params` and `GPState.mean_params` and
take Normal MAP priors (`GPConfig.mean_priors`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import resolve_device
from ..ops.kernels import _NO_LENGTHSCALE, KERNELS, Kernel
from ..utils.linalg import jitter_cholesky


@dataclasses.dataclass(frozen=True)
class GPConfig:
    kernel_name: str = "rbf"
    ard: bool = False
    # noise interval constraint (reference examples: Interval(1e-8, 1e-3))
    noise_lo: float = 1e-8
    noise_hi: float = 1e-3
    train_lik: bool = True
    standardize_y: bool = True
    # Gamma hyperpriors (gpytorch GammaPrior(3,6) lengthscale, (2,0.15)
    # outputscale when ls_prior / os_prior are None)
    use_priors: bool = False
    fit_iters: int = 100
    fit_lr: float = 0.1
    # "zero" (SOBER/_gp.py:18) or "parabolic" (BOLFI)
    mean: str = "zero"
    # ls_prior may hold per-dimension tuples: an ARD kernel with one Gamma
    # prior a lengthscale
    ls_prior: Optional[tuple] = None
    os_prior: Optional[tuple] = None
    # the parabolic mean's Normal priors: ((a_mu...), (a_var...), (b_mu...),
    # (b_var...), c_mu, c_var) (SOBER/BOLFI/_gpytorch_bolfi_model.py:389-446)
    mean_priors: Optional[tuple] = None

    def __post_init__(self):
        if self.kernel_name not in KERNELS:
            raise ValueError(f"unknown kernel {self.kernel_name!r}")
        if self.mean not in ("zero", "parabolic"):
            raise ValueError(f"mean={self.mean!r}: 'zero' or 'parabolic'")


class GPParams(NamedTuple):
    raw_lengthscale: torch.Tensor  # () or (d,) if ARD
    raw_outputscale: torch.Tensor
    raw_noise: torch.Tensor
    # the mean's parameters, empty for the zero mean; for the parabolic one
    # {"raw_a": (d,), "b": (d,), "c": ()}, a = softplus(raw_a) > 0
    # (SOBER/BOLFI/_gpytorch_bolfi_model.py:55-57)
    mean_params: dict = {}


class GPState(NamedTuple):
    """Fitted GP: hypers + data + cached Cholesky of (Kxx + sigma^2 I)."""

    config: GPConfig
    kernel: Kernel
    noise: torch.Tensor
    x: torch.Tensor          # (n, d) observed inputs (possibly padded)
    y: torch.Tensor          # (n,) standardized targets
    y_mean: torch.Tensor
    y_std: torch.Tensor
    chol: torch.Tensor       # (n, n) lower Cholesky of Kxx + sigma^2 I
    alpha: torch.Tensor      # (n,) = (Kxx + sigma^2 I)^-1 y
    # 1.0 for real rows / 0.0 for padding rows; None when unpadded
    mask: Optional[torch.Tensor] = None
    # (n, n) explicit L^-1: prediction against a wide query axis is then a
    # matmul instead of a triangular solve; None on hand-built states
    linv: Optional[torch.Tensor] = None
    # the fitted mean's parameters (GPParams.mean_params)
    mean_params: dict = {}


# ----------------------------------------------------------------------------
# parameter transforms
# ----------------------------------------------------------------------------

def _inv_softplus(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log(-torch.expm1(-y))


def _interval(raw, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(raw)


def _inv_interval(v, lo, hi):
    p = torch.clamp((v - lo) / (hi - lo), 1e-6, 1 - 1e-6)
    return torch.log(p) - torch.log1p(-p)


def materialize(params: GPParams, cfg: GPConfig) -> tuple[Kernel, torch.Tensor]:
    """raw params -> (Kernel spec, noise variance). A kernel without a
    lengthscale (Tanimoto) leaves raw_lengthscale unused."""
    kparams = {"outputscale": torch.nn.functional.softplus(params.raw_outputscale)}
    if cfg.kernel_name not in _NO_LENGTHSCALE:
        kparams["lengthscale"] = torch.nn.functional.softplus(
            params.raw_lengthscale)
    noise = _interval(params.raw_noise, cfg.noise_lo, cfg.noise_hi)
    return Kernel(cfg.kernel_name, kparams), noise


def init_params(cfg: GPConfig, n_dims: int, dtype=torch.float32,
                device=None) -> GPParams:
    """The starting raw params, on `device` (CUDA unless given). A parabolic
    mean starts at its priors' means (a at least 1e-4), or at a = 1, b = 0,
    c = 0 without priors."""
    device = resolve_device(device)
    shape = (n_dims,) if cfg.ard else ()
    f = lambda v: torch.tensor(v, dtype=dtype, device=device)
    raw_noise = _inv_interval(torch.sqrt(f(cfg.noise_lo * cfg.noise_hi)),
                              cfg.noise_lo, cfg.noise_hi)
    mean_params = {}
    if cfg.mean == "parabolic":
        if cfg.mean_priors is not None:
            a_mu, _, b_mu, _, c_mu, _ = cfg.mean_priors
            a0, b0, c0 = torch.clamp_min(f(a_mu), 1e-4), f(b_mu), f(c_mu)
        else:
            a0 = torch.ones(n_dims, dtype=dtype, device=device)
            b0 = torch.zeros(n_dims, dtype=dtype, device=device)
            c0 = f(0.0)
        mean_params = {"raw_a": _inv_softplus(a0), "b": b0, "c": c0}
    return GPParams(
        raw_lengthscale=torch.zeros(shape, dtype=dtype, device=device),
        raw_outputscale=_inv_softplus(f(1.0)),
        raw_noise=raw_noise,
        mean_params=mean_params,
    )


def mean_value(cfg: GPConfig, x: torch.Tensor,
               mean_params: Optional[dict] = None) -> torch.Tensor:
    """Prior mean m(x): zero (SOBER/_gp.py:18), or BOLFI's parabola
    sum_j a_j x_j^2 + b_j x_j + c (ParabolicMean.forward,
    SOBER/BOLFI/_gpytorch_bolfi_model.py:155-165)."""
    if cfg.mean == "zero" or not mean_params:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    a = torch.nn.functional.softplus(mean_params["raw_a"])
    return (x ** 2) @ a + x @ mean_params["b"] + mean_params["c"]


def param_tensors(params: GPParams) -> list[torch.Tensor]:
    """Every tensor of a GPParams: the three kernel and noise leaves, then
    the mean's parameters in key order."""
    return [params.raw_lengthscale, params.raw_outputscale, params.raw_noise,
            *(params.mean_params[k] for k in sorted(params.mean_params))]


def map_params(fn, params: GPParams) -> GPParams:
    """A GPParams with `fn` applied to each of its tensors."""
    return GPParams(fn(params.raw_lengthscale), fn(params.raw_outputscale),
                    fn(params.raw_noise),
                    {k: fn(v) for k, v in params.mean_params.items()})


# ----------------------------------------------------------------------------
# marginal likelihood (MAP objective)
# ----------------------------------------------------------------------------

def _gamma_logpdf(x, a, b):
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - b * x


def _normal_logpdf(x, mu, var):
    mu = torch.as_tensor(mu, dtype=x.dtype, device=x.device)
    var = torch.clamp_min(torch.as_tensor(var, dtype=x.dtype, device=x.device), 1e-12)
    return -0.5 * ((x - mu) ** 2 / var + torch.log(2 * math.pi * var))


def _masked_gram(k: torch.Tensor, noise, mask):
    """Kxx + noise*I with padding rows replaced by unit diagonal rows, so a
    fixed-size buffer can hold a growing observation set (padding
    contributes 0 to the MLL and to predictions)."""
    n = k.shape[0]
    if mask is not None:
        k = k * (mask[:, None] * mask[None, :])
        return k + noise * torch.diag(mask) + torch.diag(1.0 - mask)
    return k + noise * torch.eye(n, dtype=k.dtype, device=k.device)


class _RescuedCholesky(torch.autograd.Function):
    """cholesky(a), retried ONCE at a + extra*I when the fp32 factorization
    fails (info > 0 or a NaN pivot). The backward pass is the Murray (2016)
    Cholesky pullback A_bar = L^-T phi(L^T L_bar) L^-1 built from the FINAL
    factor only, with extra_bar = trace(A_bar) when the retry fired. Plain
    autograd would also differentiate the failed probe, whose 0 * NaN
    products poison every gradient and freeze the fit at its start
    (sober_tpu/gp/exact.py:_rescued_cholesky)."""

    @staticmethod
    def forward(ctx, a, extra):
        # jnp.linalg.cholesky factors the symmetrized input; so does this
        a = 0.5 * (a + a.mT)
        chol, info = torch.linalg.cholesky_ex(a)
        bad = bool(info > 0) or bool(torch.isnan(torch.diagonal(chol)).any())
        if bad:
            eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
            chol, _ = torch.linalg.cholesky_ex(a + extra * eye)
        ctx.save_for_backward(chol)
        ctx.bad = bad
        return chol

    @staticmethod
    def backward(ctx, l_bar):
        (chol,) = ctx.saved_tensors
        n = chol.shape[-1]
        eye = torch.eye(n, dtype=chol.dtype, device=chol.device)
        p = torch.tril(chol.mT @ l_bar) / (1.0 + eye)
        upper = chol.mT
        y = torch.linalg.solve_triangular(upper, p, upper=True)       # L^-T p
        a_bar = torch.linalg.solve_triangular(upper, y.mT, upper=True).mT  # y L^-1
        extra_bar = torch.trace(a_bar) if ctx.bad else torch.zeros(
            (), dtype=a_bar.dtype, device=a_bar.device)
        return a_bar, extra_bar


def _rescued_cholesky(a: torch.Tensor, extra: torch.Tensor) -> torch.Tensor:
    return _RescuedCholesky.apply(a, extra)


def neg_mll(params: GPParams, x: torch.Tensor, y: torch.Tensor,
            cfg: GPConfig, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Negative (MAP) marginal log likelihood per datum, as gpytorch's
    ExactMarginalLogLikelihood. `mask` marks real rows of a padded buffer."""
    kernel, noise = materialize(params, cfg)
    resid = y - mean_value(cfg, x, params.mean_params)
    if mask is not None:
        resid = resid * mask
        n = torch.sum(mask)
    else:
        n = x.shape[0]
    # the one Gram that autograd differentiates: the plain formula, not the
    # CUDA kernel (which has no backward and raises on inputs requiring
    # grad), as the JAX package never differentiates its Pallas RBF kernel
    k = _masked_gram(KERNELS[cfg.kernel_name](kernel.params, x, x), noise, mask)
    # ONE fixed-jitter Cholesky plus a SINGLE rescue retry at 1e-2: an
    # escalation loop inside every MLL evaluation is latency-disastrous, but
    # with no rescue an fp32-indefinite Gram yields a constant loss with
    # NaN->0 gradients and the fit silently returns its initialization
    scale = torch.mean(torch.diagonal(k))
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    chol = _rescued_cholesky(k + (1e-5 * scale) * eye, (1e-2 - 1e-5) * scale)
    alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
    logdiag = torch.log(torch.diagonal(chol))
    if mask is not None:
        logdiag = logdiag * mask
    mll = (-0.5 * (resid @ alpha) - torch.sum(logdiag)
           - 0.5 * n * math.log(2.0 * math.pi))
    mll = torch.where(torch.isfinite(mll), mll, torch.full_like(mll, -1e10))
    if cfg.use_priors:
        ls_a, ls_b = cfg.ls_prior or (3.0, 6.0)
        os_a, os_b = cfg.os_prior or (2.0, 0.15)
        if "lengthscale" in kernel.params:
            mll = mll + torch.sum(_gamma_logpdf(kernel.params["lengthscale"],
                                                ls_a, ls_b))
        mll = mll + _gamma_logpdf(kernel.params["outputscale"], os_a, os_b)
        if cfg.mean == "parabolic" and cfg.mean_priors is not None:
            a_mu, a_var, b_mu, b_var, c_mu, c_var = cfg.mean_priors
            mp = params.mean_params
            a = torch.nn.functional.softplus(mp["raw_a"])
            mll = mll + torch.sum(_normal_logpdf(a, a_mu, a_var))
            mll = mll + torch.sum(_normal_logpdf(mp["b"], b_mu, b_var))
            mll = mll + _normal_logpdf(mp["c"], c_mu, c_var)
    return -mll / n


# ----------------------------------------------------------------------------
# fitting
# ----------------------------------------------------------------------------

def _leaves(params: GPParams) -> GPParams:
    return map_params(lambda p: p.detach().clone().requires_grad_(True), params)


def _detached(params: GPParams) -> GPParams:
    return map_params(lambda p: p.detach().clone(), params)


def _loss(params: GPParams, x, y, cfg, mask) -> float:
    with torch.no_grad():
        return float(neg_mll(params, x, y, cfg, mask))


def _set_grads(params: GPParams, loss: torch.Tensor, cfg: GPConfig) -> None:
    """Backward, then nan_to_num the gradients (and freeze the noise when
    train_lik is off). A parameter the loss does not use (raw_lengthscale
    of a Tanimoto GP) gets a zero gradient, as jax.grad gives it."""
    for p in param_tensors(params):
        p.grad = None
    loss.backward()
    for p in param_tensors(params):
        p.grad = (torch.zeros_like(p) if p.grad is None
                  else torch.nan_to_num(p.grad))
    if not cfg.train_lik:
        params.raw_noise.grad.zero_()


def _plateau(value: float, best: float) -> bool:
    return (math.isfinite(value) and math.isfinite(best)
            and best - value <= 1e-6 * max(abs(value), 1.0))


def _fit_adam(params0: GPParams, x, y, cfg: GPConfig, mask=None) -> GPParams:
    """Adam with best-iterate tracking and a 10-step plateau stop
    (reference: train_GP_with_Adam, SOBER/_gp.py:128-155). torch's Adam
    defaults (betas 0.9/0.999, eps 1e-8) are optax.adam's."""
    params = _leaves(params0)
    opt = torch.optim.Adam(param_tensors(params), lr=cfg.fit_lr)
    best_loss, best_params, n_plateau = math.inf, _detached(params0), 0
    for _ in range(cfg.fit_iters):
        loss = neg_mll(params, x, y, cfg, mask)
        value = float(loss)
        _set_grads(params, loss, cfg)
        improved = math.isfinite(value) and value < best_loss
        if improved:
            best_params = _detached(params)
        # no improvement over the best counts toward the window; a step that
        # regresses too (best-iterate tracking makes that safe)
        n_plateau = n_plateau + 1 if _plateau(value, best_loss) else 0
        if improved:
            best_loss = value
        opt.step()
        if n_plateau >= 10:
            break
    params = _detached(params)
    final_loss = _loss(params, x, y, cfg, mask)
    best_loss = _loss(best_params, x, y, cfg, mask)
    if math.isfinite(final_loss) and final_loss <= best_loss:
        return params
    return best_params


def _fit_lbfgs(params0: GPParams, x, y, cfg: GPConfig, mask=None) -> GPParams:
    """L-BFGS with a strong-Wolfe line search (the "BoTorch" path of
    SOBER/_gp.py:174-175). optax's zoom search has no exact torch twin:
    torch's LBFGS takes one iteration per step() here, with history 10, and
    best-iterate tracking plus a 2-step plateau stop run around it."""
    params = _leaves(params0)
    opt = torch.optim.LBFGS(param_tensors(params), lr=1, max_iter=1, max_eval=8 + 1,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        loss = neg_mll(params, x, y, cfg, mask)
        _set_grads(params, loss, cfg)
        return loss

    best_loss, best_params, n_plateau = math.inf, _detached(params0), 0
    for _ in range(max(cfg.fit_iters // 4, 10)):
        before = _detached(params)
        value = float(opt.step(closure).detach())   # the loss at `before`
        improved = math.isfinite(value) and value < best_loss
        if improved:
            best_params = before
        n_plateau = n_plateau + 1 if _plateau(value, best_loss) else 0
        if improved:
            best_loss = value
        if n_plateau >= 2:
            break
    params = _detached(params)
    final_loss = _loss(params, x, y, cfg, mask)
    if math.isfinite(final_loss) and final_loss <= best_loss:
        return params
    return best_params


def fit_params(x: torch.Tensor, y: torch.Tensor, cfg: GPConfig,
               params0: Optional[GPParams] = None, optimiser: str = "lbfgs",
               mask: Optional[torch.Tensor] = None) -> GPParams:
    """Optimiser ladder: L-BFGS, falling back to Adam on a non-finite or
    regressed loss (SOBER/_gp.py:173-186). Returns detached params."""
    if params0 is None:
        params0 = init_params(cfg, x.shape[1], x.dtype, x.device)
    if optimiser == "adam":
        return _fit_adam(params0, x, y, cfg, mask)
    p_lbfgs = _fit_lbfgs(params0, x, y, cfg, mask)
    loss = _loss(p_lbfgs, x, y, cfg, mask)
    loss0 = _loss(params0, x, y, cfg, mask)
    if math.isfinite(loss) and loss <= loss0 + 1e-6:
        return p_lbfgs
    return _fit_adam(params0, x, y, cfg, mask)


def _masked_stats(y_raw, mask):
    if mask is None:
        return torch.mean(y_raw), torch.clamp_min(torch.std(y_raw), 1e-12)
    n = torch.clamp_min(torch.sum(mask), 2.0)
    mean = torch.sum(y_raw * mask) / n
    var = torch.sum(((y_raw - mean) * mask) ** 2) / (n - 1.0)
    return mean, torch.clamp_min(torch.sqrt(var), 1e-12)


@torch.no_grad()
def build_state(params: GPParams, x: torch.Tensor, y_raw: torch.Tensor,
                cfg: GPConfig, mask: Optional[torch.Tensor] = None) -> GPState:
    """Materialize the prediction cache (factor, alpha, L^-1) for fitted
    params."""
    y_raw = y_raw.reshape(-1)
    if cfg.standardize_y:
        y_mean, y_std = _masked_stats(y_raw, mask)
    else:
        y_mean = torch.zeros((), dtype=y_raw.dtype, device=y_raw.device)
        y_std = torch.ones((), dtype=y_raw.dtype, device=y_raw.device)
    y = (y_raw - y_mean) / y_std
    params = _detached(params)
    kernel, noise = materialize(params, cfg)
    resid = y - mean_value(cfg, x, params.mean_params)
    if mask is not None:
        resid = resid * mask
        y = y * mask
    k = _masked_gram(kernel.gram(x, x), noise, mask)
    chol, _ = jitter_cholesky(k)
    alpha = torch.cholesky_solve(resid[:, None], chol)[:, 0]
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return GPState(cfg, kernel, noise, x, y, y_mean, y_std, chol, alpha,
                   mask, linv, params.mean_params)


def raw_params_from_state(state: GPState) -> GPParams:
    """Invert `materialize`: the raw GPParams of a fitted state, to
    warm-start the next refit (`fit_gp(..., params0=...)`). The noise is
    clamped strictly inside its interval, where the inverse is finite."""
    cfg = state.config
    kp = state.kernel.params
    raw_os = _inv_softplus(torch.clamp_min(kp["outputscale"], 1e-20))
    if "lengthscale" in kp:
        raw_ls = _inv_softplus(torch.clamp_min(kp["lengthscale"], 1e-20))
    else:
        raw_ls = torch.zeros((), dtype=state.x.dtype, device=state.x.device)
    lo, hi = cfg.noise_lo, cfg.noise_hi
    noise = torch.clamp(state.noise, lo + 1e-9 * (hi - lo), hi - 1e-9 * (hi - lo))
    return GPParams(raw_lengthscale=raw_ls, raw_outputscale=raw_os,
                    raw_noise=_inv_interval(noise, lo, hi),
                    mean_params=state.mean_params)


def fit_gp(x: torch.Tensor, y: torch.Tensor, cfg: Optional[GPConfig] = None,
           optimiser: str = "lbfgs", mask: Optional[torch.Tensor] = None,
           params0: Optional[GPParams] = None, **cfg_kwargs) -> GPState:
    """One-call GP fit: standardize y, MAP-fit the hypers on that scale and
    return the fitted state (reference update_gp, SOBER/_gp.py:189-209)."""
    if cfg is None:
        cfg = GPConfig(**cfg_kwargs)
    y = y.reshape(-1)
    y_fit = y
    if cfg.standardize_y:
        m, sd = _masked_stats(y, mask)
        y_fit = (y - m) / sd
        if mask is not None:
            y_fit = y_fit * mask
    params = fit_params(x, y_fit, cfg, params0=params0, optimiser=optimiser,
                        mask=mask)
    return build_state(params, x, y, cfg, mask=mask)


# ----------------------------------------------------------------------------
# prediction (standardized scale)
# ----------------------------------------------------------------------------

def posterior_mean_var(state: GPState, xq: torch.Tensor,
                       include_noise: bool = True):
    """Posterior mean/variance at xq on the standardized-y scale (variance
    includes observation noise, as the reference's predict does),
    differentiable in xq (on the card through the RBF kernel's autograd
    Function)."""
    kqx = state.kernel.gram(xq, state.x)                  # (m, n)
    if state.mask is not None:
        kqx = kqx * state.mask[None, :]
    mean = mean_value(state.config, xq, state.mean_params) + kqx @ state.alpha
    if state.linv is not None:
        v = state.linv @ kqx.T                            # (n, m)
    else:
        v = torch.linalg.solve_triangular(state.chol, kqx.T, upper=False)
    var = torch.clamp_min(state.kernel.diag(xq) - torch.sum(v * v, dim=0),
                          1e-12)
    if include_noise:
        var = var + state.noise
    return mean, var


@torch.no_grad()
def predict(state: GPState, xq: torch.Tensor, include_noise: bool = True):
    """posterior_mean_var without gradients: the acquisitions, pi and the
    polish's final read."""
    return posterior_mean_var(state, xq, include_noise)


def predict_raw(state: GPState, xq: torch.Tensor, include_noise: bool = True):
    """Posterior on the original y scale."""
    mean, var = predict(state, xq, include_noise)
    return mean * state.y_std + state.y_mean, var * state.y_std ** 2


def predict_mean(state: GPState, xq: torch.Tensor) -> torch.Tensor:
    return predict(state, xq)[0]


@torch.no_grad()
def predictive_covariance(state: GPState, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Posterior cross-covariance k(x, y | D) = Kxy - KxX (Kxx + s^2 I)^-1 KXy,
    as two cached-L^-1 matmuls."""
    kxy = state.kernel.gram(x, y)
    kxX = state.kernel.gram(x, state.x)
    kXy = state.kernel.gram(state.x, y)
    if state.mask is not None:
        kxX = kxX * state.mask[None, :]
        kXy = kXy * state.mask[:, None]
    if state.linv is not None:
        a = state.linv @ kxX.T                            # (n, |x|)
        b = state.linv @ kXy                              # (n, |y|)
    else:
        a = torch.linalg.solve_triangular(state.chol, kxX.T, upper=False)
        b = torch.linalg.solve_triangular(state.chol, kXy, upper=False)
    return kxy - a.T @ b


def posterior_mean(state: GPState, xq: torch.Tensor) -> torch.Tensor:
    """Posterior mean at xq on the standardized scale, differentiable in
    xq (on the card through the RBF kernel's autograd Function)."""
    kqx = state.kernel.gram(xq, state.x)
    if state.mask is not None:
        kqx = kqx * state.mask[None, :]
    return mean_value(state.config, xq, state.mean_params) + kqx @ state.alpha


def polish_posterior_mean(state: GPState, starts: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor,
                          n_steps: int = 50, lr: float = 0.02):
    """Multi-start projected-Adam ascent of the posterior mean inside the
    box [lo, hi], each step scaled by the box's span; returns (polished
    points, their posterior means). The exploit polish of
    Sober.next_batch(polish=True) (sober_tpu/gp/exact.py:617)."""
    span = hi - lo
    x = starts.detach().clone()
    m, v = torch.zeros_like(x), torch.zeros_like(x)
    for t in range(1, n_steps + 1):
        xg = x.requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(-torch.sum(posterior_mean(state, xg)), xg)
        x = xg.detach()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1.0 - 0.9 ** t)
        vh = v / (1.0 - 0.999 ** t)
        x = x - lr * span[None, :] * mh / (torch.sqrt(vh) + 1e-8)
        x = torch.clamp(x, lo[None, :], hi[None, :])
    return x, predict(state, x, include_noise=False)[0]


def posterior_max_mean(state: GPState) -> torch.Tensor:
    """eta = max posterior mean over the training inputs (SOBER/_pi.py:17)."""
    mean, _ = predict(state, state.x)
    if state.mask is not None:
        mean = torch.where(state.mask > 0, mean, float("-inf"))
    return torch.max(mean)


def pad_observations(x: torch.Tensor, y: torch.Tensor, bucket: int = 128):
    """Pad (x, y) to the next multiple of `bucket` rows; returns
    (x_pad, y_pad, mask)."""
    n = x.shape[0]
    pad = -(-n // bucket) * bucket - n
    x_pad = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    y_pad = torch.cat([y.reshape(-1), y.new_zeros((pad,))])
    mask = torch.cat([x.new_ones((n,)), x.new_zeros((pad,))])
    return x_pad, y_pad, mask


def fit_gp_padded(x: torch.Tensor, y: torch.Tensor,
                  cfg: Optional[GPConfig] = None, optimiser: str = "adam",
                  bucket: int = 128, params0: Optional[GPParams] = None,
                  **cfg_kwargs) -> GPState:
    """fit_gp on a bucket-padded observation buffer (Adam by default, the
    reference's own fallback optimiser)."""
    x_pad, y_pad, mask = pad_observations(x, y, bucket)
    return fit_gp(x_pad, y_pad, cfg, optimiser=optimiser, mask=mask,
                  params0=params0, **cfg_kwargs)
