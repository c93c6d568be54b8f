"""Truncated multivariate normal sampling (port of sober_tpu/priors/tmvn.py;
SOBER/_tmvn.py).

Two samplers:

  * ``method="gibbs"`` (default): parallel Gibbs chains, one a sample, each
    sweep a loop over the coordinates whose univariate truncated normals
    are drawn exactly by inverse CDF; the sweeps are a Python loop drawing
    from one explicit `torch.Generator`. Burn-in scales with the chain's
    mixing speed (the spectral radius of the Gauss-Seidel iteration matrix
    of the precision, on the host in float64), and each conditional is
    drawn on whichever side of its mean keeps the CDF values small, so
    boxes deep in the tail (z up to ~12) sample without float32
    quantization.
  * ``method="tilting"``: Botev's minimax exponential tilting. The setup
    once per distribution (the variable ordering, the Cholesky factor, the
    damped-Newton solve of the tilting saddle point) runs on the host in
    float64 numpy, copied from the JAX package; the accept-reject rounds
    draw all proposals in parallel on the device, at most `max_rounds` of
    them, with one host read of the accepted count a round. The draws are
    iid; `last_accept_rate` keeps the empirical acceptance rate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..utils.linalg import jitter_cholesky
from .mvn_cdf import _log_phi, _phi

_CLIP = 1e-30


def _phinv(p: torch.Tensor) -> torch.Tensor:
    return torch.special.ndtri(torch.clamp(p, _CLIP, 1 - 1e-7))


def _sample_trunc_std_normal(alpha, beta, u):
    """Z ~ N(0, 1) truncated to [alpha, beta] by inverse CDF with a tail
    flip: a box right of the mean samples the mirrored -Z in
    [-beta, -alpha], where the CDF values are small and well resolved in
    float32, then negates."""
    flip = (alpha + beta) > 0.0
    a_eff = torch.where(flip, -beta, alpha)
    b_eff = torch.where(flip, -alpha, beta)
    pa = _phi(a_eff)
    pb = _phi(b_eff)
    z = _phinv(pa + (pb - pa) * u)
    # a box of numerically zero width collapses onto its boundary
    z = torch.minimum(torch.maximum(z, a_eff), b_eff)
    return torch.where(flip, -z, z)


class TruncatedMVN:
    """N(mu, cov) restricted to the box [lb, ub] (SOBER/_tmvn.py:11
    TruncatedMVN: __init__(mu, cov, bounds), sample(n)), on `device` (CUDA
    unless given)."""

    def __init__(self, mu, cov, bounds, burn_in: int | None = None,
                 thin: int = 2, method: str = "gibbs", device=None):
        if method not in ("gibbs", "tilting"):
            raise ValueError(f"method must be 'gibbs' or 'tilting', got {method!r}")
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.method = method
        self.mu = f32(mu)
        self.cov = f32(cov)
        self.lb = f32(bounds[0])
        self.ub = f32(bounds[1])
        self.device = self.mu.device
        self.d = self.mu.shape[0]
        self.thin = thin
        self.last_accept_rate = None
        # precision-based conditionals: X_i | X_-i ~ N(m_i, s_i^2) with
        # m_i = mu_i - (1 / P_ii) sum_{j != i} P_ij (x_j - mu_j)
        chol, _ = jitter_cholesky(self.cov)
        eye = torch.eye(self.d, dtype=torch.float32, device=self.device)
        self.prec = torch.cholesky_solve(eye, chol)
        self.cond_sd = torch.sqrt(1.0 / torch.diagonal(self.prec))
        self.burn_in = self._auto_burn_in() if burn_in is None else int(burn_in)
        if method == "tilting":
            host = lambda a: np.asarray(torch.as_tensor(a).cpu(), np.float64)
            self._tilt = TiltingFactors.build(host(mu), host(cov), host(bounds[0]),
                                              host(bounds[1]), device=self.device)

    def _auto_burn_in(self, target: float = 1e-3, lo: int = 30, hi: int = 512) -> int:
        """Sweeps that contract the initialization bias below `target`.
        Systematic-scan Gibbs on a Gaussian is Gauss-Seidel on the precision
        P = L + D + L^T, whose error contracts at rho(M) a sweep,
        M = -(L + D)^-1 L^T; computed in float64 on the host from the float32
        precision."""
        p = self.prec.double().cpu().numpy()
        if p.shape[0] == 1:
            return lo
        try:
            m = -np.linalg.solve(np.tril(p), np.triu(p, 1))
            rho = float(np.max(np.abs(np.linalg.eigvals(m))))
        except np.linalg.LinAlgError:
            return hi
        if not np.isfinite(rho) or rho >= 1.0:
            return hi
        if rho <= 0.0:
            return lo
        need = int(np.ceil(np.log(target) / np.log(rho)))
        return int(np.clip(need, lo, hi))

    def sample(self, gen: torch.Generator, n_samples: int) -> torch.Tensor:
        """(n_samples, d) draws: Gibbs, one chain a sample after burn-in and
        thinning; tilting, iid accept-reject draws."""
        if self.method == "tilting":
            t = self._tilt
            x, n_acc, n_prop = tmvn_tilting_sample(
                gen, t.l_scaled, t.lb, t.ub, t.mu_tilt, t.psistar, t.l_unscaled,
                t.inv_perm, self.mu, n_samples)
            self.last_accept_rate = n_acc / max(n_prop, 1)
            return x
        return tmvn_gibbs_sample(gen, self.mu, self.prec, self.cond_sd, self.lb,
                                 self.ub, n_samples, self.burn_in + self.thin)


def _gibbs_sweep(x, u, mu, prec, cond_sd, lb, ub):
    """One sweep over the coordinates for all chains; x, u (n, d). Returns a
    new x."""
    x = x.clone()
    for i in range(mu.shape[0]):
        p_row = prec[i]
        # the conditional mean, own coordinate left out
        delta = (x - mu[None, :]) @ p_row - p_row[i] * (x[:, i] - mu[i])
        m = mu[i] - delta / prec[i, i]
        s = cond_sd[i]
        z = _sample_trunc_std_normal((lb[i] - m) / s, (ub[i] - m) / s, u[:, i])
        x[:, i] = m + s * z
    return x


def tmvn_gibbs_sample(gen, mu, prec, cond_sd, lb, ub, n_samples: int,
                      n_sweeps: int) -> torch.Tensor:
    """(n_samples, d) Gibbs draws, one chain a sample, started at mu clipped
    into the box; each sweep draws its uniforms from `gen`."""
    d = mu.shape[0]
    x = torch.minimum(torch.maximum(mu, lb), ub)[None, :].expand(n_samples, d)
    for _ in range(n_sweeps):
        u = torch.rand((n_samples, d), generator=gen, device=mu.device)
        x = _gibbs_sweep(x, u, mu, prec, cond_sd, lb, ub)
    return x


# ----------------------------------------------------------------------------
# minimax-tilting exactness mode (Botev 2016; SOBER/_tmvn.py:90-399)
# ----------------------------------------------------------------------------
#
# What happens once per distribution (the acceptance-maximizing ordering,
# the sequential Cholesky, the saddle-point solve) is small-d float64 host
# work; what happens per sample (sequential conditional draws, the
# likelihood-ratio test) runs on the device with every proposal in parallel.


def _ln_prob_np(a, b):
    """log P(a < Z < b), Z ~ N(0, 1), float64 on the host, accurate in both
    tails: scipy's log_ndtr on whichever side of the origin keeps the
    arguments small (the reference uses erfcx, SOBER/_tmvn.py:402-429)."""
    from scipy.special import log_ndtr, ndtr

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = np.empty(np.broadcast(a, b).shape, np.float64)
    a, b = np.broadcast_arrays(a, b)
    pos = a > 0                       # box in the upper tail
    neg = b < 0                       # box in the lower tail
    mid = ~(pos | neg)                # box across the origin
    if pos.any():
        la = log_ndtr(-a[pos])
        lbb = log_ndtr(-b[pos])
        out[pos] = la + np.log1p(-np.exp(lbb - la))
    if neg.any():
        la = log_ndtr(a[neg])
        lbb = log_ndtr(b[neg])
        out[neg] = lbb + np.log1p(-np.exp(la - lbb))
    if mid.any():
        out[mid] = np.log1p(-(ndtr(a[mid]) + ndtr(-b[mid])))
    return out


def _tilt_terms_np(y, l_sc, lb, ub):
    """The pieces of the tilting objective psi and its derivatives at
    y = (x_{1..d-1}, mu_{1..d-1}): the shifted box (tl, tu), its log mass w
    and the normalized boundary densities (pl, pu)."""
    d = lb.shape[0]
    x = np.zeros(d)
    mu = np.zeros(d)
    x[:d - 1] = y[:d - 1]
    mu[:d - 1] = y[d - 1:]
    shift = l_sc @ x
    tl = lb - mu - shift
    tu = ub - mu - shift
    w = _ln_prob_np(tl, tu)
    inv_sqrt2pi = 1.0 / np.sqrt(2.0 * np.pi)
    pl = np.exp(-0.5 * np.minimum(tl, np.inf) ** 2 - w) * inv_sqrt2pi
    pu = np.exp(-0.5 * np.minimum(tu, np.inf) ** 2 - w) * inv_sqrt2pi
    pl[np.isinf(tl)] = 0.0
    pu[np.isinf(tu)] = 0.0
    return x, mu, tl, tu, w, pl, pu


def _tilt_grad_np(y, l_sc, lb, ub):
    """Gradient and Jacobian of the saddle conditions grad psi = 0 over
    y = (x_{1..d-1}, mu_{1..d-1}) (the system the reference hands to
    scipy.optimize.root, SOBER/_tmvn.py:153)."""
    d = lb.shape[0]
    x, mu, tl, tu, w, pl, pu = _tilt_terms_np(y, l_sc, lb, ub)
    P = pl - pu                       # E[Z_k] of each tilted conditional
    grad_x = -mu[:d - 1] + P @ l_sc[:, :d - 1]
    grad_mu = (mu - x + P)[:d - 1]
    grad = np.concatenate([grad_x, grad_mu])

    tl0 = np.where(np.isinf(tl), 0.0, tl)
    tu0 = np.where(np.isinf(tu), 0.0, tu)
    dP = -P**2 + tl0 * pl - tu0 * pu  # dE[Z_k] / d(shift)
    dl = dP[:, None] * l_sc
    blk_xx = (l_sc.T @ dl)[:d - 1, :d - 1]
    blk_mx = (dl - np.eye(d))[:d - 1, :d - 1]
    blk_mm = np.diag(1.0 + dP[:d - 1])
    jac = np.block([[blk_xx, blk_mx.T], [blk_mx, blk_mm]])
    return grad, jac


def _psi_np(y, l_sc, lb, ub):
    """psi(x, mu) = sum_k ln P(tl_k < Z < tu_k) + mu_k^2 / 2 - x_k mu_k, the
    log acceptance bound of the tilted proposal (SOBER/_tmvn.py:302)."""
    x, mu, tl, tu, w, _, _ = _tilt_terms_np(y, l_sc, lb, ub)
    return float(np.sum(w + 0.5 * mu**2 - x * mu))


def _colperm_chol_np(cov, lb, ub, eps=1e-10):
    """Sequential Cholesky with the acceptance-maximizing ordering: each
    step takes the remaining coordinate whose conditional box has the least
    mass, then extends the factor (Gibson-Glasbey-Elston; the reference's
    colperm, SOBER/_tmvn.py:356). Returns (L, perm, lb_p, ub_p)."""
    d = cov.shape[0]
    cov = cov.copy()
    lb = lb.copy()
    ub = ub.copy()
    L = np.zeros_like(cov)
    z = np.zeros(d)                   # running conditional means
    perm = np.arange(d)
    for j in range(d):
        rest = slice(j, d)
        s2 = np.diag(cov)[rest] - np.sum(L[rest, :j] ** 2, axis=1)
        s = np.sqrt(np.maximum(s2, eps))
        head = L[rest, :j] @ z[:j]
        mass = _ln_prob_np((lb[rest] - head) / s, (ub[rest] - head) / s)
        k = j + int(np.argmin(mass))
        # swap j <-> k in cov, bounds, factor rows and perm
        cov[[j, k], :] = cov[[k, j], :]
        cov[:, [j, k]] = cov[:, [k, j]]
        L[[j, k], :] = L[[k, j], :]
        lb[[j, k]] = lb[[k, j]]
        ub[[j, k]] = ub[[k, j]]
        perm[[j, k]] = perm[[k, j]]
        s2 = cov[j, j] - np.sum(L[j, :j] ** 2)
        if s2 < -0.01:
            raise ValueError("covariance is not positive semi-definite")
        L[j, j] = np.sqrt(max(s2, eps))
        if j + 1 < d:
            L[j + 1:, j] = (cov[j + 1:, j] - L[j + 1:, :j] @ L[j, :j]) / L[j, j]
        # the truncated coordinate's conditional mean feeds the next pick
        tl = (lb[j] - L[j, :j] @ z[:j]) / L[j, j]
        tu = (ub[j] - L[j, :j] @ z[:j]) / L[j, j]
        w = _ln_prob_np(np.array([tl]), np.array([tu]))[0]
        z[j] = ((np.exp(-0.5 * min(tl, 1e30) ** 2 - w)
                 - np.exp(-0.5 * min(tu, 1e30) ** 2 - w)) / np.sqrt(2 * np.pi))
    return L, perm, lb, ub


class TiltingFactors(NamedTuple):
    """The once-per-distribution setup of the minimax-tilting sampler,
    built on the host in float64; the device tensors are float32."""

    l_scaled: torch.Tensor    # (d, d) unit-diagonal Cholesky minus I
    l_unscaled: torch.Tensor  # (d, d) Cholesky of the permuted covariance
    lb: torch.Tensor          # (d,) permuted, diagonal-scaled shifted bounds
    ub: torch.Tensor
    mu_tilt: torch.Tensor     # (d,) tilting means (last entry 0)
    psistar: float            # log acceptance bound at the saddle
    inv_perm: torch.Tensor    # (d,) undoes the ordering

    @classmethod
    def build(cls, mu, cov, lb, ub, newton_iters: int = 80, device=None):
        """From float64 numpy mu, cov, lb, ub; the tensors on `device` (CUDA
        unless given)."""
        d = mu.shape[0]
        L, perm, lb_p, ub_p = _colperm_chol_np(cov, lb - mu, ub - mu)
        diag = np.diag(L).copy()
        l_sc = L / diag[:, None] - np.eye(d)
        lb_s = lb_p / diag
        ub_s = ub_p / diag

        y = np.zeros(2 * (d - 1))
        if d > 1:
            # damped Newton on grad psi = 0 (in place of scipy.optimize.root
            # 'hybr'): a fixed budget, monotone in |grad|
            g, J = _tilt_grad_np(y, l_sc, lb_s, ub_s)
            for _ in range(newton_iters):
                gn = float(np.linalg.norm(g))
                if gn < 1e-10:
                    break
                try:
                    step = np.linalg.solve(J, g)
                except np.linalg.LinAlgError:
                    step = np.linalg.lstsq(J, g, rcond=None)[0]
                t = 1.0
                for _ in range(30):
                    y_try = y - t * step
                    g_try, J_try = _tilt_grad_np(y_try, l_sc, lb_s, ub_s)
                    if np.linalg.norm(g_try) < gn:
                        y, g, J = y_try, g_try, J_try
                        break
                    t *= 0.5
                else:
                    break             # no descent direction left
        psistar = _psi_np(y, l_sc, lb_s, ub_s)
        mu_t = np.zeros(d)
        mu_t[:d - 1] = y[d - 1:]
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
        return cls(f32(l_sc), f32(L), f32(lb_s), f32(ub_s), f32(mu_t), float(psistar),
                   torch.as_tensor(np.argsort(perm), device=device))


def _ln_normal_prob(a, b):
    """log P(a < Z < b) elementwise on the device, float32-safe in both
    tails; every branch is where-guarded, so no lane sees an argument
    outside its domain."""
    pos = a > 0
    neg = b < 0
    la_p = _log_phi(-torch.where(pos, a, 1.0))
    lb_p = _log_phi(-torch.where(pos, b, 2.0))
    out_pos = la_p + torch.log1p(-torch.exp(lb_p - la_p))
    la_n = _log_phi(torch.where(neg, a, -2.0))
    lb_n = _log_phi(torch.where(neg, b, -1.0))
    out_neg = lb_n + torch.log1p(-torch.exp(la_n - lb_n))
    a_m = torch.where(pos, 0.0, a)
    b_m = torch.where(neg, 0.0, b)
    out_mid = torch.log1p(-(_phi(a_m) + _phi(-b_m)))
    return torch.where(pos, out_pos, torch.where(neg, out_neg, out_mid))


def _tilting_propose(gen, l_sc, lb, ub, mu_t, n: int):
    """One round of n parallel proposals from the tilted sequential
    importance density: (Z (n, d) in the scaled, permuted coordinates,
    logpr (n,) the log likelihood ratios) (reference mvnrnd,
    SOBER/_tmvn.py:179-196)."""
    d = lb.shape[0]
    u = torch.rand((d, n), generator=gen, device=l_sc.device)
    z = torch.zeros((n, d), dtype=l_sc.dtype, device=l_sc.device)
    logpr = torch.zeros(n, dtype=l_sc.dtype, device=l_sc.device)
    for k in range(d):
        shift = z @ l_sc[k]           # only the first k entries of the row count
        tl = lb[k] - mu_t[k] - shift
        tu = ub[k] - mu_t[k] - shift
        zk = mu_t[k] + _sample_trunc_std_normal(tl, tu, u[k])
        logpr = logpr + _ln_normal_prob(tl, tu) + 0.5 * mu_t[k] ** 2 - mu_t[k] * zk
        z[:, k] = zk
    return z, logpr


def tmvn_tilting_sample(gen, l_sc, lb, ub, mu_t, psistar: float, l_unscaled,
                        inv_perm, mu_orig, n_samples: int, max_rounds: int = 512):
    """iid minimax-tilting draws. Each round proposes n_samples tilted draws
    in parallel, accepts where -log U > psistar - logpr (SOBER/_tmvn.py:110)
    and fills the next free rows with the survivors; the last round
    accepts everything, so the loop ends (the reference's "approximately
    distributed" fallback, _tmvn.py:117). One host read of the accepted
    count a round. Returns (samples (n_samples, d), n_accepted, n_proposed)."""
    d = lb.shape[0]
    buf = torch.zeros((n_samples, d), dtype=l_sc.dtype, device=l_sc.device)
    tiny = torch.finfo(torch.float32).tiny
    count = rounds = n_acc = 0
    while count < n_samples and rounds < max_rounds:
        z, logpr = _tilting_propose(gen, l_sc, lb, ub, mu_t, n_samples)
        u = torch.clamp_min(torch.rand(n_samples, generator=gen, device=l_sc.device), tiny)
        accept = -torch.log(u) > (psistar - logpr)
        n_round = int(accept.sum())
        n_acc += n_round
        if rounds >= max_rounds - 1:
            accept = torch.ones_like(accept)
            n_round = n_samples
        take = min(n_round, n_samples - count)
        buf[count:count + take] = z[accept][:take]
        count += take
        rounds += 1
    x = buf @ l_unscaled.T            # back to the covariance's scale
    x = x[:, inv_perm]                # undo the ordering
    return x + mu_orig[None, :], n_acc, rounds * n_samples
