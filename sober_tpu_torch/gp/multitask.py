"""Multi-output GP regression, the inverse-model surrogate (port of
sober_tpu/gp/multitask.py; the reference's KroneckerMultiTaskGP,
SOBER/_inverse_modelling.py:159-172).

* `fit_icm_gp`: the intrinsic coregionalization model
  K((x,t),(x',s)) = k(x,x') B[t,s] with a learned task covariance
  B = L L^T + diag(v), fitted by the exact MLL through the Kronecker
  eigen-identity: with k_x = Qx Lx Qx^T and B = Qb Lb Qb^T,
  (k_x (x) B + s^2 I)^-1 is elementwise in the joint eigenbasis, so an
  evaluation costs one n x n and one T x T eigh. The fit is an eager Adam
  loop with best-iterate tracking, differentiating through both eighs.
* `fit_multitask_gp`: T independent GPs on shared inputs, one Adam MAP fit
  a column.

The data kernel `_icm_kx` stays plain torch: the fit differentiates it in
the lengthscale, as the JAX package computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from .exact import (GPConfig, GPState, _fit_adam, _inv_softplus, build_state,
                    init_params, predict)


class MultiTaskGPState(NamedTuple):
    states: tuple            # one GPState a task
    n_tasks: int


def fit_multitask_gp(x: torch.Tensor, y: torch.Tensor,
                     cfg: GPConfig | None = None) -> MultiTaskGPState:
    """T independent GPs on shared inputs x (n, d), one a column of y
    (n, T), each an Adam MAP fit (the JAX package vmaps the same fit)."""
    if cfg is None:
        cfg = GPConfig(ard=False, noise_lo=1e-6, noise_hi=1.0,
                       standardize_y=True, use_priors=False, fit_iters=100)
    states = []
    for y_col in y.T:
        ys = y_col
        if cfg.standardize_y:
            ys = (y_col - y_col.mean()) / torch.clamp_min(y_col.std(), 1e-12)
        params = _fit_adam(init_params(cfg, x.shape[1], x.dtype, x.device), x, ys, cfg)
        states.append(build_state(params, x, y_col, cfg))
    return MultiTaskGPState(tuple(states), y.shape[1])


def predict_multitask(mt: MultiTaskGPState, xq: torch.Tensor,
                      include_noise: bool = True):
    """(mean (m, T), var (m, T)) on the raw output scale."""
    mus, vars_ = [], []
    for st in mt.states:
        mu, var = predict(st, xq, include_noise)
        mus.append(mu * st.y_std + st.y_mean)
        vars_.append(var * st.y_std ** 2)
    return torch.stack(mus, dim=1), torch.stack(vars_, dim=1)


def sample_multitask(mt: MultiTaskGPState, gen: torch.Generator,
                     xq: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(n_samples, m, T) draws from the independent-output posterior."""
    mu, var = predict_multitask(mt, xq)
    z = torch.randn((n_samples,) + tuple(mu.shape), generator=gen, device=mu.device)
    return mu[None] + torch.sqrt(torch.clamp_min(var, 0.0))[None] * z


# ----------------------------------------------------------------------------
# ICM with a learned task covariance
# ----------------------------------------------------------------------------
#
# Data-major layout: with Y the (n, T) targets, (k_x (x) B) vec(Y) =
# vec(k_x Y B), and
#   (k_x (x) B + s^2 I)^-1 vec(Y) = vec(Qx (Yt / D) Qb^T),
#   Yt = Qx^T Y Qb,  D[i,u] = lx[i] lb[u] + s^2
# (Bonilla et al. 2008).

_ICM_JITTER = 1e-6
_ICM_KERNELS = {"rbf": 0, "matern52": 1}


class ICMState(NamedTuple):
    """A fitted ICM multitask GP with its caches."""

    x: torch.Tensor            # (n, d) inputs
    yt: torch.Tensor           # (n, T) eigenbasis-projected standardized targets
    y_mean: torch.Tensor       # (T,)
    y_std: torch.Tensor        # (T,)
    lengthscale: torch.Tensor  # () isotropic or (d,) ARD
    noise: torch.Tensor
    task_cov: torch.Tensor     # (T, T) learned B
    qx: torch.Tensor           # (n, n) eigenvectors of k_x(X, X)
    lx: torch.Tensor           # (n,) its eigenvalues, clamped >= 0
    qb: torch.Tensor           # (T, T) eigenvectors of B
    lb: torch.Tensor           # (T,) its eigenvalues, clamped >= 0
    alpha: torch.Tensor        # (n, T) = unvec((k_x (x) B + s^2 I)^-1 vec(Y))
    kernel_id: int             # 0 = RBF, 1 = Matern-5/2

    @property
    def n_tasks(self) -> int:
        return self.task_cov.shape[0]

    @property
    def task_correlation(self) -> torch.Tensor:
        """B normalized to unit diagonal (the learned task correlations)."""
        s = torch.sqrt(torch.clamp_min(torch.diag(self.task_cov), 1e-30))
        return self.task_cov / (s[:, None] * s[None, :])


def _icm_kx(x1, x2, lengthscale, kernel_id: int) -> torch.Tensor:
    """Unit-scale data kernel: RBF (kernel_id 0) or Matern-5/2 (1), the
    lengthscale broadcast over the input dimensions (a (d,) one is ARD).
    The +1e-24 floor keeps the square root's gradient finite at r = 0."""
    d2 = torch.sum((x1[:, None, :] - x2[None, :, :]) ** 2
                   / torch.clamp_min(lengthscale, 1e-12) ** 2, dim=-1)
    if kernel_id == 0:
        return torch.exp(-0.5 * d2)
    sq5r = torch.sqrt(5.0 * d2 + 1e-24)
    return (1.0 + sq5r + (5.0 / 3.0) * d2) * torch.exp(-sq5r)


class _Eigh(torch.autograd.Function):
    """torch.linalg.eigh whose backward leaves out exactly tied eigenvalue
    pairs. Their 1/(lam_j - lam_i) terms are 0/0 for a loss that does not
    depend on the basis chosen inside the tied subspace, as the ICM's MLL
    does not; torch's (and JAX's) backward turns them into NaN. An RBF Gram
    of far-apart inputs (kx = I after exp underflows) or a float32 cluster
    of eigenvalues ties exactly; untied pairs keep the textbook terms, so
    the gradient is eigh's own wherever that is finite."""

    @staticmethod
    def forward(ctx, a):
        lam, v = torch.linalg.eigh(a)
        ctx.save_for_backward(lam, v)
        return lam, v

    @staticmethod
    def backward(ctx, g_lam, g_v):
        lam, v = ctx.saved_tensors
        inner = torch.zeros_like(v) if g_lam is None else torch.diag_embed(g_lam)
        if g_v is not None:
            gap = lam[None, :] - lam[:, None]              # lam_j - lam_i
            tied = gap == 0
            inner = inner + torch.where(tied, 0.0, 1.0 / torch.where(tied, 1.0, gap)) * (
                v.mT @ g_v)
        g_a = v @ inner @ v.mT
        return 0.5 * (g_a + g_a.mT)


def _icm_build(raw: dict, x: torch.Tensor, kernel_id: int):
    """(lengthscale, noise, B, Qx, lx, Qb, lb, D) from the raw parameters."""
    softplus = torch.nn.functional.softplus
    ls = softplus(raw["raw_ls"])
    noise = softplus(raw["raw_noise"]) + 1e-6
    l_f = raw["l_f"]
    b = l_f @ l_f.T + torch.diag(softplus(raw["raw_v"]) + 1e-6)
    kx = _icm_kx(x, x, ls, kernel_id) + _ICM_JITTER * torch.eye(
        x.shape[0], dtype=x.dtype, device=x.device)
    lx, qx = _Eigh.apply(kx)
    lb, qb = _Eigh.apply(b)
    lx, lb = torch.clamp_min(lx, 0.0), torch.clamp_min(lb, 0.0)
    d = lx[:, None] * lb[None, :] + noise
    return ls, noise, b, qx, lx, qb, lb, d


def _icm_neg_mll(raw: dict, x: torch.Tensor, ys: torch.Tensor,
                 kernel_id: int) -> torch.Tensor:
    """-log p(vec(Y)) through the Kronecker eigen-identity."""
    *_, qx, lx, qb, lb, d = _icm_build(raw, x, kernel_id)
    yt = qx.T @ ys @ qb
    quad = torch.sum(yt * yt / d)
    logdet = torch.sum(torch.log(d))
    return 0.5 * (quad + logdet + ys.numel() * math.log(2.0 * math.pi))


def _icm_init(x: torch.Tensor, t: int, rank: int, ard: bool) -> dict:
    """The starting raw parameters: B close to I (a small coupled factor
    and a near-unit diagonal), the diagonal deliberately non-constant:
    eigh's backward has 1/(lb_i - lb_j) terms, so every eigenvalue starts
    distinct."""
    kw = dict(dtype=x.dtype, device=x.device)
    ls_shape = (x.shape[1],) if ard else ()
    return {"raw_ls": _inv_softplus(torch.ones(ls_shape, **kw)),
            "raw_noise": _inv_softplus(torch.tensor(0.05, **kw)),
            "l_f": 0.1 * torch.eye(t, rank, **kw),
            "raw_v": _inv_softplus(torch.linspace(0.8, 1.0, t, **kw))}


def _icm_state(raw: dict, x, ys, y_mean, y_std, kernel_id: int) -> ICMState:
    ls, noise, b, qx, lx, qb, lb, d = _icm_build(raw, x, kernel_id)
    yt = qx.T @ ys @ qb
    alpha = qx @ (yt / d) @ qb.T
    return ICMState(x, yt, y_mean, y_std, ls, noise, b, qx, lx, qb, lb, alpha,
                    kernel_id)


def _fit_icm(x: torch.Tensor, y: torch.Tensor, kernel_id: int, rank: int,
             fit_iters: int, ard: bool, lr: float = 0.05) -> ICMState:
    """`fit_iters` Adam steps on the exact MLL, keeping the best iterate
    (the loss is read on the host each step). Should a gradient still be
    non-finite, the parameters turn NaN and no later loss is finite: the
    loop stops there (torch's eigh raises on NaN), where JAX's scan runs on
    and keeps the same best iterate."""
    y_mean = y.mean(dim=0)
    y_std = torch.clamp_min(y.std(dim=0), 1e-12)
    ys = (y - y_mean) / y_std
    raw = {k: v.requires_grad_(True) for k, v in _icm_init(x, y.shape[1], rank, ard).items()}
    opt = torch.optim.Adam(list(raw.values()), lr=lr)
    best_raw = {k: v.detach().clone() for k, v in raw.items()}
    best_loss = math.inf
    for _ in range(fit_iters):
        opt.zero_grad()
        loss = _icm_neg_mll(raw, x, ys, kernel_id)
        loss.backward()
        value = float(loss)
        if math.isfinite(value) and value < best_loss:
            best_loss = value
            best_raw = {k: v.detach().clone() for k, v in raw.items()}
        opt.step()
        if not all(bool(torch.isfinite(v).all()) for v in raw.values()):
            break
    with torch.no_grad():
        return _icm_state(best_raw, x, ys, y_mean, y_std, kernel_id)


def fit_icm_gp(x: torch.Tensor, y: torch.Tensor, rank: int | None = None,
               fit_iters: int = 200, ard: bool = False,
               kernel: str = "rbf") -> ICMState:
    """Fit the ICM multitask GP by exact MLL (Adam, best-iterate tracking).

    x: (n, d) inputs; y: (n, T) targets, both on the fit's device; rank:
    the width of B's low-rank factor (default T, full rank, botorch's
    KroneckerMultiTaskGP default); ard: per-dimension lengthscales;
    kernel: "rbf" or "matern52" (ard with matern52 is botorch's default
    data kernel)."""
    if kernel not in _ICM_KERNELS:
        raise ValueError(f"kernel must be one of {sorted(_ICM_KERNELS)}; got {kernel!r}")
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    t = y.shape[1]
    return _fit_icm(x, y, _ICM_KERNELS[kernel], t if rank is None else min(rank, t),
                    fit_iters, ard)


def _icm_query(st: ICMState, xq: torch.Tensor):
    """A = Qx^T k_x(X, X*) (n, m), k_x(X, X*) and the inverse joint
    eigenvalues (n, T)."""
    kxq = _icm_kx(st.x, xq, st.lengthscale, st.kernel_id)
    inv_d = 1.0 / (st.lx[:, None] * st.lb[None, :] + st.noise)
    return kxq, st.qx.T @ kxq, inv_d


@torch.no_grad()
def predict_icm(st: ICMState, xq: torch.Tensor, include_noise: bool = True):
    """Marginal posterior per (query, task): (mean (m, T), var (m, T)) on
    the raw output scale."""
    kxq, a, inv_d = _icm_query(st, xq)
    mu = kxq.T @ st.alpha @ st.task_cov
    c = st.qb.T @ st.task_cov                         # (T, T): rows = eigen
    prior_var = (1.0 + _ICM_JITTER) * torch.diag(st.task_cov)
    var = torch.clamp_min(prior_var[None, :] - (a * a).T @ inv_d @ (c * c), 1e-12)
    if include_noise:
        var = var + st.noise
    return mu * st.y_std[None, :] + st.y_mean[None, :], var * st.y_std[None, :] ** 2


@torch.no_grad()
def task_posterior_cov_icm(st: ICMState, xq: torch.Tensor,
                           include_noise: bool = True) -> torch.Tensor:
    """The full T x T posterior covariance across tasks at each query
    ((m, T, T), raw scale): the joint uncertainty the independent model
    cannot represent."""
    _, a, inv_d = _icm_query(st, xq)
    c = st.qb.T @ st.task_cov
    g = (a * a).T @ inv_d                             # (m, T) eigen-weights
    cov = (1.0 + _ICM_JITTER) * st.task_cov[None] - torch.einsum("mu,ut,us->mts", g, c, c)
    if include_noise:
        cov = cov + st.noise * torch.eye(st.n_tasks, dtype=cov.dtype, device=cov.device)[None]
    return cov * (st.y_std[:, None] * st.y_std[None, :])[None]


@torch.no_grad()
def sample_icm(st: ICMState, gen: torch.Generator, xq: torch.Tensor,
               n_samples: int) -> torch.Tensor:
    """(n_samples, m, T) draws from the joint-task posterior at each query
    (the cross-task correlations kept, unlike sample_multitask)."""
    mu, _ = predict_icm(st, xq)
    cov = task_posterior_cov_icm(st, xq)
    eye = torch.eye(st.n_tasks, dtype=cov.dtype, device=cov.device)
    chols = torch.linalg.cholesky(cov + 1e-9 * eye)
    z = torch.randn((n_samples, xq.shape[0], st.n_tasks), generator=gen, device=xq.device)
    return mu[None] + torch.einsum("mts,nms->nmt", chols, z)
