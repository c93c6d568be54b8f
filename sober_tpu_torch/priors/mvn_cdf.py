"""Differentiable multivariate normal orthant and box probabilities (port
of sober_tpu/priors/mvn_cdf.py; SOBER/mvnorm/).

The forward pass is Genz's separation of variables in the log domain: a
loop over the d dimensions on tensors vectorized over the scrambled-Sobol
nodes (and over a batch of upper limits). The closed-form gradient

    dPhi_d(b; mu, S) / d b_i = N(b_i; mu_i, S_ii) * Phi_{d-1}(b_-i | b_i)

(SOBER/mvnorm/Phi.py:37-78), and its covariance counterpart from the
bivariate densities and the second-order conditional CDFs, is the backward
of `_MvnCdf`, a `torch.autograd.Function` that computes only the inputs
`ctx.needs_input_grad` asks for. The nodes are the port's Sobol points,
which equal the JAX package's bit for bit, with its seeds (7 for the CDF,
11 for the box).
"""
from __future__ import annotations

import functools
import math

import torch

from ..utils.linalg import jitter_cholesky
from ..utils.sobol import sobol_engine, sobol_sample

_LOG_SQRT_2PI = 0.9189385332046727


def _phi(z: torch.Tensor) -> torch.Tensor:
    """Phi(z) = erfc(-z / sqrt 2) / 2: float32 keeps the lower tail down to
    z ~ -13 (torch.special.ndtr returns 0 below z ~ -5.5 in float32)."""
    return 0.5 * torch.erfc(-z * math.sqrt(0.5))


def _log_phi(z: torch.Tensor) -> torch.Tensor:
    return torch.special.log_ndtr(z)


def _ndtri_log(logp: torch.Tensor) -> torch.Tensor:
    """Inverse of log_ndtr: z with log Phi(z) = logp, down to logp = -5000
    (z ~ -100). The mid-range starts from ndtri(exp(logp)), the tail from
    z ~ -sqrt(-2 logp); five Newton steps on log_ndtr(z) - logp polish
    either start to float32 accuracy."""
    logp = torch.clamp(logp, -5000.0, -1e-7)                  # log(1 - 1e-7)
    p = torch.exp(logp)
    z = torch.special.ndtri(torch.clamp(p, 1e-30, 1.0 - 1e-7))
    t = torch.sqrt(-2.0 * torch.clamp_max(logp, -1e-12))
    z = torch.where(logp < -15.0, -t, z)
    for _ in range(5):
        logcdf = _log_phi(z)
        logpdf = -0.5 * z * z - _LOG_SQRT_2PI
        # Newton step (logcdf - logp) / (d log_ndtr / dz), derivative pdf/cdf
        z = z - (logcdf - logp) * torch.exp(torch.clamp(logcdf - logpdf, -60.0, 60.0))
    return z


def _log_sub(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """log(exp(log_a) - exp(log_b)); -inf wherever log_b >= log_a (both
    -inf included)."""
    diff = log_b - log_a
    diff = torch.where(torch.isnan(diff), 0.0, torch.clamp_max(diff, 0.0))
    return log_a + torch.log1p(-torch.exp(diff))


@functools.lru_cache(maxsize=64)
def _qmc_nodes(dim: int, seed: int, n: int, device: torch.device) -> torch.Tensor:
    """The first n scrambled-Sobol points of `dim` dimensions for `seed`,
    built once per (dim, seed, n, device); callers never write to them."""
    return sobol_sample(sobol_engine(dim, seed=seed, device=device), 0, n)


def _genz_box_logprob(lower_std: torch.Tensor, upper_std: torch.Tensor,
                      chol_corr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """log P(lower_std < Z < upper_std), Z ~ N(0, C), C = L L^T, by Genz's
    scan in the log domain; the limits are (..., d) (a one-sided CDF passes
    lower_std = -inf), w the (n_qmc, d - 1) nodes. Returns (...)."""
    lower_std, upper_std = torch.broadcast_tensors(lower_std, upper_std)
    batch, d = upper_std.shape[:-1], upper_std.shape[-1]
    lo = lower_std.reshape(-1, d)
    hi = upper_std.reshape(-1, d)
    log_hi = _log_phi(hi[:, 0] / chol_corr[0, 0])
    log_lo = _log_phi(lo[:, 0] / chol_corr[0, 0])
    log_p0 = _log_sub(log_hi, log_lo)
    if d == 1:
        return log_p0.reshape(batch)
    n = w.shape[0]
    b = lo.shape[0]
    log_prob = log_p0[:, None].expand(b, n)
    y = torch.zeros((b, n, d), dtype=hi.dtype, device=hi.device)
    log_lo = log_lo[:, None].expand(b, n)
    log_hi = log_hi[:, None].expand(b, n)
    for i in range(1, d):
        # y_{i-1} by inverse CDF inside the previous truncation:
        # p = lo + w (hi - lo) = hi * (w + (1 - w) lo / hi), in log space
        r = torch.where(torch.isinf(log_hi), 0.0,
                        torch.exp(torch.clamp_max(log_lo - log_hi, 0.0)))
        mix = w[None, :, i - 1] * (1.0 - r) + r
        log_p = log_hi + torch.log(torch.clamp(mix, 1e-38, 1.0))
        y[:, :, i - 1] = _ndtri_log(log_p)
        shift = y @ chol_corr[i, :]
        log_hi = _log_phi((hi[:, i:i + 1] - shift) / chol_corr[i, i])
        log_lo = _log_phi((lo[:, i:i + 1] - shift) / chol_corr[i, i])
        log_prob = log_prob + _log_sub(log_hi, log_lo)
    out = torch.logsumexp(log_prob, dim=1) - math.log(n)
    return out.reshape(batch)


def _genz_cdf(upper_std: torch.Tensor, chol_corr: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """P(Z < upper_std), Z ~ N(0, C): the one-sided Genz scan."""
    lower = torch.full_like(upper_std, -math.inf)
    return torch.exp(_genz_box_logprob(lower, upper_std, chol_corr, w))


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def mvn_box_prob(lower, upper, loc, covariance_matrix,
                 n_qmc: int = 8192) -> torch.Tensor:
    """P(lower < X < upper) for X ~ N(loc, cov): the truncated Gaussian's
    normalization constant (in place of the reference's cdf(ub) - cdf(lb)
    at SOBER/_prior.py:150-152, which is the box probability only in one
    dimension)."""
    return torch.exp(mvn_box_log_prob(lower, upper, loc, covariance_matrix, n_qmc))


def mvn_box_log_prob(lower, upper, loc, covariance_matrix,
                     n_qmc: int = 8192) -> torch.Tensor:
    """log P(lower < X < upper): finite where the probability itself
    underflows float32 (boxes beyond ~13 sigma)."""
    cov = torch.as_tensor(covariance_matrix)
    dev = cov.device
    upper = torch.atleast_1d(_as_f32(upper, dev))
    lower = torch.atleast_1d(_as_f32(lower, dev))
    loc = torch.broadcast_to(torch.atleast_1d(_as_f32(loc, dev)), upper.shape)
    cov = cov.to(torch.float32)
    d = upper.shape[-1]
    sd = torch.sqrt(torch.diagonal(cov))
    if d == 1:
        z_hi = (upper[..., 0] - loc[..., 0]) / sd[0]
        z_lo = (lower[..., 0] - loc[..., 0]) / sd[0]
        return _log_sub(_log_phi(z_hi), _log_phi(z_lo))
    corr = cov / (sd[:, None] * sd[None, :])
    chol, _ = jitter_cholesky(corr)
    w = _qmc_nodes(d - 1, 11, n_qmc, dev)
    return _genz_box_logprob((lower - loc) / sd, (upper - loc) / sd, chol, w)


def multivariate_normal_cdf(value, loc, covariance_matrix,
                            n_qmc: int = 8192) -> torch.Tensor:
    """P(X < value), X ~ N(loc, covariance_matrix)
    (SOBER/mvnorm/multivariate_normal_cdf.py:13). value and loc broadcast
    against each other over leading batch dims; covariance_matrix may carry
    leading batch dims (..., d, d) too, and each batch element then gets its
    own Genz evaluation. Differentiable in value, loc and the covariance;
    computed in float32 on the covariance's device."""
    dev = torch.as_tensor(covariance_matrix).device
    cov = _as_f32(covariance_matrix, dev)
    value = torch.atleast_1d(_as_f32(value, dev))
    loc = torch.atleast_1d(_as_f32(loc, dev))
    shape = torch.broadcast_shapes(value.shape, loc.shape)
    value = torch.broadcast_to(value, shape)
    loc = torch.broadcast_to(loc, shape)
    if cov.dim() <= 2:
        return _MvnCdf.apply(value, loc, cov, n_qmc)
    d = cov.shape[-1]
    batch = torch.broadcast_shapes(value.shape[:-1], cov.shape[:-2])
    value = torch.broadcast_to(value, batch + (d,)).reshape(-1, d)
    loc = torch.broadcast_to(loc, batch + (d,)).reshape(-1, d)
    cov = torch.broadcast_to(cov, batch + (d, d)).reshape(-1, d, d)
    vals = [_MvnCdf.apply(v, l, c, n_qmc) for v, l, c in zip(value, loc, cov)]
    return torch.stack(vals).reshape(batch)


def _cdf_forward(value: torch.Tensor, loc: torch.Tensor, cov: torch.Tensor,
                 n_qmc: int) -> torch.Tensor:
    """The shared-covariance CDF, value/loc (..., d), cov (d, d) (or a
    single-element one when d == 1); no autograd."""
    value = torch.atleast_1d(value)
    loc = torch.broadcast_to(torch.atleast_1d(loc), value.shape)
    d = value.shape[-1]
    if d == 1:
        sd = torch.sqrt(cov.reshape(()) if cov.numel() == 1 else cov[..., 0, 0])
        return _phi((value[..., 0] - loc[..., 0]) / sd)
    sd = torch.sqrt(torch.diagonal(cov))
    corr = cov / (sd[:, None] * sd[None, :])
    chol, _ = jitter_cholesky(corr)
    w = _qmc_nodes(d - 1, 7, n_qmc, cov.device)
    return _genz_cdf((value - loc) / sd, chol, w)


def _pair_pdf(b: torch.Tensor, cov: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Bivariate normal density at (b_i, b_j) under the (i, j) marginal of
    N(0, cov) (reference phi2_sub, SOBER/mvnorm/Phi.py:19-28)."""
    sii, sjj, sij = cov[i, i], cov[j, j], cov[i, j]
    det = torch.clamp_min(sii * sjj - sij ** 2, 1e-30)
    quad = (sjj * b[..., i] ** 2 + sii * b[..., j] ** 2
            - 2.0 * sij * b[..., i] * b[..., j]) / det
    return torch.exp(-0.5 * quad) / (2.0 * math.pi * torch.sqrt(det))


def _second_order_cdf(b: torch.Tensor, cov: torch.Tensor, i: int, j: int,
                      d: int, n_qmc: int) -> torch.Tensor:
    """Phi_{d-2} of the other coordinates given X_i = b_i, X_j = b_j
    (the reference's nested make_condition, SOBER/mvnorm/Phi.py:62-69)."""
    if d == 2:
        return torch.ones(b.shape[:-1], dtype=b.dtype, device=b.device)
    others = [k for k in range(d) if k not in (i, j)]
    pair = [i, j]
    cov_pp = cov[pair][:, pair]
    cov_op = cov[others][:, pair]
    cov_oo = cov[others][:, others]
    gain = cov_op @ torch.linalg.inv(cov_pp)                 # (d-2, 2)
    b_pair = torch.stack([b[..., i], b[..., j]], dim=-1)
    mu_cond = torch.einsum("ok,...k->...o", gain, b_pair)
    cov_cond = cov_oo - gain @ cov_op.T
    return _cdf_forward(b[..., others] - mu_cond,
                        torch.zeros(d - 2, dtype=b.dtype, device=b.device),
                        cov_cond, max(n_qmc // 4, 1024))


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """g summed over the dims that broadcasting added to a tensor of
    `shape`."""
    while g.dim() > len(shape):
        g = g.sum(0)
    for k, n in enumerate(shape):
        if n == 1 and g.shape[k] != 1:
            g = g.sum(k, keepdim=True)
    return g


class _MvnCdf(torch.autograd.Function):
    """The shared-covariance CDF with its closed-form gradients in value,
    loc and covariance, the transpose of the JAX package's custom JVP
    (sober_tpu/priors/mvn_cdf.py:246-329):

        g_i  = dPhi/db_i = N(b_i; 0, S_ii) * Phi_{d-1}(conditional given b_i)
        H_ij = N_2((b_i, b_j); S_pair) * Phi_{d-2}(second-order conditional)
        D_i  = -(b_i g_i + sum_{j != i} H_ij S_ij) / S_ii
        dPhi/dS = 0.5 * (H + diag(D)),

    with b = value - loc, so dPhi/dloc = -g. The covariance branch costs
    d(d-1)/2 extra (d-2)-dimensional CDFs and runs only when the covariance
    needs a gradient."""

    @staticmethod
    def forward(ctx, value, loc, cov, n_qmc):
        ctx.save_for_backward(value, loc, cov)
        ctx.n_qmc = n_qmc
        return _cdf_forward(value, loc, cov, n_qmc)

    @staticmethod
    def backward(ctx, g_out):
        value, loc, cov = ctx.saved_tensors
        n_qmc = ctx.n_qmc
        need_value, need_loc, need_cov = ctx.needs_input_grad[:3]
        v = torch.atleast_1d(value)
        b = v - torch.broadcast_to(torch.atleast_1d(loc), v.shape)
        d = b.shape[-1]
        cov2 = cov.reshape(1, 1) if d == 1 else cov
        sd = torch.sqrt(torch.diagonal(cov2))
        grads = torch.stack([_grad_coord(b, cov2, sd, i, d, n_qmc)
                             for i in range(d)], dim=-1)
        g_b = g_out[..., None] * grads
        value_bar = _sum_to(g_b, value.shape).reshape(value.shape) if need_value else None
        loc_bar = _sum_to(-g_b, loc.shape).reshape(loc.shape) if need_loc else None
        cov_bar = None
        if need_cov:
            if d == 1:
                pdf = torch.exp(-0.5 * (b[..., 0] / sd[0]) ** 2) / (
                    sd[0] * math.sqrt(2 * math.pi))
                m = -0.5 * b[..., 0] / cov2[0, 0] * pdf
                cov_bar = torch.sum(g_out * m).reshape(cov.shape)
            else:
                h = torch.zeros(b.shape[:-1] + (d, d), dtype=b.dtype, device=b.device)
                for i in range(d):
                    for j in range(i + 1, d):
                        hij = _pair_pdf(b, cov2, i, j) * _second_order_cdf(
                            b, cov2, i, j, d, n_qmc)
                        h[..., i, j] = hij
                        h[..., j, i] = hij
                # the diagonal by the heat-equation relation (Phi.py:71-73)
                hs = torch.einsum("...ij,ij->...i", h, cov2)
                diag = -(b * grads + hs) / torch.diagonal(cov2)
                m = 0.5 * h + torch.diag_embed(0.5 * diag)
                cov_bar = torch.einsum("...,...ij->ij", g_out, m)
        return value_bar, loc_bar, cov_bar, None


def _grad_coord(b, cov, sd, i: int, d: int, n_qmc: int) -> torch.Tensor:
    """dPhi/db_i: the marginal density at b_i times the CDF of the other
    coordinates conditioned on X_i = b_i (SOBER/mvnorm/conditioning.py:3-24)."""
    pdf_i = torch.exp(-0.5 * (b[..., i] / sd[i]) ** 2) / (sd[i] * math.sqrt(2 * math.pi))
    if d == 1:
        return pdf_i
    others = [j for j in range(d) if j != i]
    cov_oo = cov[others][:, others]
    cov_oi = cov[others, i]
    mu_cond = b[..., others] - cov_oi * (b[..., i:i + 1] / cov[i, i])
    cov_cond = cov_oo - torch.outer(cov_oi, cov_oi) / cov[i, i]
    cdf_cond = _cdf_forward(mu_cond, torch.zeros(d - 1, dtype=b.dtype, device=b.device),
                            cov_cond, max(n_qmc // 4, 1024))
    return pdf_i * cdf_cond
