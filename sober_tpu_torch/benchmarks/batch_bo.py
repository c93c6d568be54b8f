"""Competitor batch-BO baselines (port of sober_tpu/benchmarks/batch_bo.py;
benchmarks/_batch_bo.py of the reference): Thompson sampling, decoupled
(pathwise) TS, DPP-TS, GIBBON, hallucination (kriging believer), local
penalisation, TurBO and the SOBER-TS hybrid.

Joint and pathwise posterior samples come from gp/sampling.py; the
acquisition optimizer is Sobol restarts and a projected Adam polish
(torch.optim.Adam, optax.adam's update). The greedy argmax without
replacement runs on the device and reads nothing back. Every posterior
Gram goes through `Kernel.gram` (the RBF kernel on the card), and SOBER-TS
recombines through core/rchq.py (the CAR kernel). On a padded GP state the
baselines read the real rows only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..core.pi import normal_cdf
from ..core.rchq import _top, recombination
from ..gp.exact import GPState, posterior_mean_var, predict, predictive_covariance
from ..gp.sampling import decoupled_sampler, joint_posterior_samples
from ..utils.linalg import jitter_cholesky
from ..utils.sobol import sobol_engine, sobol_sample


def _seed(gen: torch.Generator) -> int:
    """An integer seed in [0, 2^31 - 1) from the generator (the JAX
    package's jax.random.randint)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))


def _real_rows(model: GPState):
    """(x, standardized y) of the observations, a padded state's padding
    left out."""
    if model.mask is None:
        return model.x, model.y
    real = model.mask > 0
    return model.x[real], model.y[real]


def greedy_argmax(y: torch.Tensor) -> torch.Tensor:
    """Row i's argmax among the columns no earlier row took, for each row
    of y (B, n): the indices (B,), on y's device. Ties go to the lower
    index, as numpy's argmax."""
    taken = torch.zeros(y.shape[1], dtype=torch.bool, device=y.device)
    idx = torch.empty(y.shape[0], dtype=torch.int64, device=y.device)
    for i in range(y.shape[0]):
        j = torch.argmax(y[i].masked_fill(taken, -math.inf))
        idx[i] = j
        taken[j] = True
    return idx


# ----------------------------------------------------------------------------
# acquisition machinery
# ----------------------------------------------------------------------------

def expected_improvement(state: GPState, eta, x: torch.Tensor) -> torch.Tensor:
    """EI over eta, differentiable in x."""
    mu, var = posterior_mean_var(state, x, include_noise=False)
    sd = torch.sqrt(torch.clamp_min(var, 1e-30))
    z = (mu - eta) / sd
    pdf = torch.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    return (mu - eta) * normal_cdf(z) + sd * pdf


def maximize_from_seed(seed: int, acq_fn: Callable, bounds: torch.Tensor,
                       q: int = 1, num_restarts: int = 5, raw_samples: int = 512,
                       polish_steps: int = 30) -> torch.Tensor:
    """maximize_acqf with its Sobol seed given."""
    d = bounds.shape[1]
    lo, hi = bounds[0], bounds[1]
    raw = lo + (hi - lo) * sobol_sample(sobol_engine(d, seed=seed, device=bounds.device),
                                        0, raw_samples)
    with torch.no_grad():
        _, top = _top(acq_fn(raw), num_restarts)
    x = raw[top].clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=0.05 * float(torch.max(hi - lo)))
    for _ in range(polish_steps):
        opt.zero_grad()
        with torch.enable_grad():
            (-torch.sum(acq_fn(x))).backward()
        opt.step()
        with torch.no_grad():
            x.copy_(torch.clamp(x, lo[None], hi[None]))
    x = x.detach()
    with torch.no_grad():
        _, best = _top(acq_fn(x), min(q, num_restarts))
    return x[best]


def maximize_acqf(gen: torch.Generator, acq_fn: Callable, bounds: torch.Tensor,
                  q: int = 1, num_restarts: int = 5, raw_samples: int = 512,
                  polish_steps: int = 30) -> torch.Tensor:
    """Sobol restarts + projected Adam ascent, the optimize_acqf analogue of
    benchmarks/_batch_bo.py: the top `num_restarts` of `raw_samples` Sobol
    points, `polish_steps` Adam steps clipped to the box, the best q."""
    return maximize_from_seed(_seed(gen), acq_fn, bounds, q, num_restarts,
                              raw_samples, polish_steps)


# ----------------------------------------------------------------------------
# baselines
# ----------------------------------------------------------------------------

def thompson_sampling(gen: torch.Generator, model: GPState, prior, n_rec: int,
                      batch_size: int) -> torch.Tensor:
    """Batch TS: one joint posterior draw over a candidate pool per slot,
    argmax without replacement (benchmarks/_batch_bo.py:20-25)."""
    x_cand = prior.sample(gen, n_rec)
    y = joint_posterior_samples(gen, model, x_cand, batch_size)
    return x_cand[greedy_argmax(y)]


def decoupled_thompson_sampling(gen: torch.Generator, model: GPState, prior,
                                n_rec: int, batch_size: int,
                                num_basis: int = 4096) -> torch.Tensor:
    """Pathwise (RFF Matheron) batch TS (benchmarks/_batch_bo.py:27-41)."""
    x_cand = prior.sample(gen, n_rec)
    paths = decoupled_sampler(gen, model, batch_size, num_basis=num_basis)
    return x_cand[greedy_argmax(paths(x_cand))]


def _dpp_logdet(model: GPState, x_batch: torch.Tensor, dpp_lambda: float,
                lambda_mode: str) -> torch.Tensor:
    """log det of the regularized DPP kernel K_S = I + lambda s^-2 K_post
    ('mult') or (I + s^-2 K_post)^lambda ('pow'), the mixture kernel of
    Nava et al. 2021 (benchmarks/dpp_ts_bo/snippet_dppts.py:42-50)."""
    k_post = predictive_covariance(model, x_batch, x_batch)
    eye = torch.eye(x_batch.shape[0], dtype=k_post.dtype, device=k_post.device)
    inv_s2 = 1.0 / torch.clamp_min(model.noise, 1e-12)
    if lambda_mode == "mult":
        k_s, lam_pow = eye + dpp_lambda * inv_s2 * k_post, 1.0
    elif lambda_mode == "pow":
        k_s, lam_pow = eye + inv_s2 * k_post, dpp_lambda
    else:
        raise ValueError("lambda_mode must be 'mult' or 'pow'")
    chol, _ = jitter_cholesky(k_s)
    return lam_pow * 2.0 * torch.sum(torch.log(torch.diagonal(chol)))


def dpp_ts(gen: torch.Generator, model: GPState, prior, n_rec: int,
           batch_size: int, n_mcmc: int = 50, dpp_lambda: float = 1.0,
           lambda_mode: str = "mult", first_ts: bool = False) -> torch.Tensor:
    """DPP-TS (Nava et al. 2021, AISTATS 2022), the paper's Algorithm-1
    MCMC over the mixture of TS and a DPP on the posterior covariance
    (benchmarks/dpp_ts_bo/snippet_dppts.py:19-91): each slot starts at an
    independent TS draw (duplicates allowed); each step swaps a fresh TS
    proposal into a uniformly random slot and accepts with
    min(1, det(K_S') / det(K_S)); first_ts pins slot 0 (DPP-TS-alt)."""
    x_cand = prior.sample(gen, n_rec)
    y = joint_posterior_samples(gen, model, x_cand, batch_size + n_mcmc)
    argmax = torch.argmax(y, dim=1).tolist()
    idx = argmax[:batch_size]
    cur_ld = float(_dpp_logdet(model, x_cand[idx], dpp_lambda, lambda_mode))
    rng = np.random.default_rng(_seed(gen))
    lo_slot = 1 if first_ts else 0
    for t in range(n_mcmc):
        slot = int(rng.integers(lo_slot, batch_size))
        cand = list(idx)
        cand[slot] = argmax[batch_size + t]
        new_ld = float(_dpp_logdet(model, x_cand[cand], dpp_lambda, lambda_mode))
        # Metropolis: alpha = min(1, det' / det) (snippet_dppts.py:74-76)
        if np.log(rng.uniform()) < new_ld - cur_ld:
            idx, cur_ld = cand, new_ld
    return x_cand[idx]


def gibbon(gen: torch.Generator, model: GPState, prior, n_rec: int,
           batch_size: int, n_max_samples: int = 16) -> torch.Tensor:
    """GIBBON-style max-value entropy batch selection: the information gain
    about the max value (sampled max values) with a log-det repulsion,
    greedily maximized (benchmarks/_batch_bo.py:52-63). Chosen points are
    also excluded outright: the repulsion vanishes at near-zero-variance
    points, which would otherwise be picked again."""
    x_cand = prior.sample(gen, n_rec)
    mu, var = predict(model, x_cand, include_noise=False)
    sd = torch.sqrt(torch.clamp_min(var, 1e-30))
    y_samples = joint_posterior_samples(gen, model, x_cand[:512], n_max_samples)
    y_star = torch.max(y_samples, dim=1).values                    # (S,)
    gamma = (y_star[:, None] - mu[None, :]) / sd[None, :]          # (S, n)
    pdf = torch.exp(-0.5 * gamma ** 2) / math.sqrt(2 * math.pi)
    ratio = gamma * pdf / torch.clamp_min(normal_cdf(gamma), 1e-10)
    info = -0.5 * torch.mean(torch.log1p(-torch.clamp_max(ratio, 1 - 1e-6)), dim=0)
    penalty = torch.zeros_like(info)
    taken = torch.zeros(n_rec, dtype=torch.bool, device=x_cand.device)
    chosen = torch.empty(batch_size, dtype=torch.int64, device=x_cand.device)
    for i in range(batch_size):
        j = torch.argmax((info - penalty).masked_fill(taken, -math.inf))
        chosen[i] = j
        taken[j] = True
        cov_j = predictive_covariance(model, x_cand, x_cand[j[None]])[:, 0]
        corr2 = cov_j ** 2 / torch.clamp_min(var * var[j], 1e-30)
        penalty = penalty - 0.5 * torch.log1p(-torch.clamp(corr2, 0.0, 1 - 1e-6))
    return x_cand[chosen]


def hallucination(gen: torch.Generator, model: GPState, set_model: Callable,
                  prior, batch_size: int) -> torch.Tensor:
    """Kriging believer: sequential EI, each pick fantasized at its
    posterior mean and the GP refit by `set_model(x, y)` on the raw scale
    (benchmarks/_batch_bo.py:65-90). Starts from the real rows of the
    state."""
    x_f, y_s = _real_rows(model)
    y_f = y_s * model.y_std + model.y_mean
    batch = []
    for _ in range(batch_size):
        m = set_model(x_f, y_f)
        eta = torch.max(_real_rows(m)[1])
        x_next = maximize_acqf(gen, lambda x: expected_improvement(m, eta, x),
                               prior.bounds, q=1, num_restarts=5,
                               raw_samples=max(batch_size, 64))
        mu_next, _ = predict(m, x_next)
        x_f = torch.cat([x_f, x_next])
        y_f = torch.cat([y_f, mu_next * m.y_std + m.y_mean])
        batch.append(x_next)
    return torch.cat(batch)


def local_penalisation(gen: torch.Generator, model: GPState, prior,
                       batch_size: int, lipschitz: float = 1.0) -> torch.Tensor:
    """Sequential EI with erfc local penalties around the points already
    chosen (benchmarks/_batch_bo.py:92-111,171-193)."""
    eta = torch.max(_real_rows(model)[1])
    batch, balls = [], []

    def penalised(x):
        ei = expected_improvement(model, eta, x)
        for xb, mu_b, var_b in balls:
            dist = torch.sqrt(torch.sum((x - xb[None, :]) ** 2, dim=1))
            z = (lipschitz * dist - eta + mu_b) / torch.sqrt(2.0 * torch.clamp_min(var_b, 1e-30))
            ei = 0.5 * torch.erfc(-z) * ei
        return ei

    for _ in range(batch_size):
        x_next = maximize_acqf(gen, penalised, prior.bounds, q=1, num_restarts=5,
                               raw_samples=max(batch_size, 64))[0]
        mu_b, var_b = predict(model, x_next[None, :], include_noise=False)
        balls.append((x_next, mu_b[0], var_b[0]))
        batch.append(x_next)
    return torch.stack(batch)


# ----------------------------------------------------------------------------
# TurBO (benchmarks/_batch_bo.py:113-149, 195-230)
# ----------------------------------------------------------------------------

@dataclass
class TurboState:
    dim: int
    batch_size: int
    length: float = 0.8
    length_min: float = 0.5 ** 7
    length_max: float = 1.6
    failure_counter: int = 0
    failure_tolerance: int = field(default=0)
    success_counter: int = 0
    success_tolerance: int = 10
    best_value: float = -float("inf")
    restart_triggered: bool = False

    def __post_init__(self):
        self.failure_tolerance = math.ceil(
            max(4.0 / self.batch_size, self.dim / self.batch_size))


def update_turbo_state(state: TurboState, y_next) -> TurboState:
    """(benchmarks/_batch_bo.py:213-230)"""
    y_max = float(torch.max(torch.as_tensor(y_next)))
    if y_max > state.best_value + 1e-3 * abs(state.best_value):
        state.success_counter += 1
        state.failure_counter = 0
    else:
        state.success_counter = 0
        state.failure_counter += 1
    if state.success_counter == state.success_tolerance:
        state.length = min(2.0 * state.length, state.length_max)
        state.success_counter = 0
    elif state.failure_counter == state.failure_tolerance:
        state.length /= 2.0
        state.failure_counter = 0
    state.best_value = max(state.best_value, y_max)
    if state.length < state.length_min:
        state.restart_triggered = True
    return state


def turbo(gen: torch.Generator, state: TurboState, model: GPState, prior,
          batch_size: int) -> torch.Tensor:
    """Trust-region TS (benchmarks/_batch_bo.py:113-149): Sobol candidates
    in a box around the best observation, each perturbing a random subset
    of coordinates, then batch TS over them."""
    lo, hi = prior.bounds[0], prior.bounds[1]
    x_real, y_real = _real_rows(model)
    x_norm = (x_real - lo) / (hi - lo)
    dim = x_norm.shape[1]
    n_cand = min(5000, max(2000, 200 * dim))
    x_center = x_norm[torch.argmax(y_real)]
    ls = torch.atleast_1d(model.kernel.params["lengthscale"])
    if ls.shape[0] == 1:
        weights = torch.ones(dim, device=x_norm.device)
    else:
        weights = ls / ls.mean()
        weights = weights / torch.prod(weights)
    tr_lb = torch.clamp(x_center - weights * state.length / 2.0, 0.0, 1.0)
    tr_ub = torch.clamp(x_center + weights * state.length / 2.0, 0.0, 1.0)
    sobol = sobol_engine(dim, seed=_seed(gen), device=x_norm.device)
    pert = tr_lb + (tr_ub - tr_lb) * sobol_sample(sobol, 0, n_cand)
    prob_perturb = min(20.0 / dim, 1.0)
    mask = torch.rand((n_cand, dim), generator=gen, device=x_norm.device) <= prob_perturb
    none_on = ~torch.any(mask, dim=1)
    rand_dim = torch.randint(0, dim, (n_cand,), generator=gen, device=x_norm.device)
    fix = torch.nn.functional.one_hot(rand_dim, dim).bool()
    mask = torch.where(none_on[:, None], fix, mask)
    x_cand = lo + (hi - lo) * torch.where(mask, pert, x_center[None, :])
    y = joint_posterior_samples(gen, model, x_cand, batch_size)
    return x_cand[greedy_argmax(y)]


def sober_ts(gen: torch.Generator, model: GPState, prior, batch_size: int,
             n_cand_super: int = 20000, n_cand: int = 2000,
             n_nys: int = 200) -> torch.Tensor:
    """SOBER-TS hybrid: a decoupled-TS supersample of n_cand points, then
    kernel recombination on the posterior covariance down to the batch
    (benchmarks/_batch_bo.py:151-169)."""
    x_cand = decoupled_thompson_sampling(gen, model, prior, n_cand_super, n_cand)
    weights = torch.full((n_cand,), 1.0 / n_cand, device=x_cand.device)
    kernel = lambda x, y: predictive_covariance(model, x, y)
    idx, _ = recombination(x_cand, x_cand[:n_nys], batch_size, kernel,
                           init_weights=weights)
    return x_cand[idx]
