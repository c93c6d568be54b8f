"""BOLFI: Bayesian optimization for likelihood-free inference surrogates
(port of sober_tpu/apps/bolfi.py; SOBER/BOLFI/).

A GP surrogate with a learned per-dimension parabolic mean (its Normal
priors seeded by a least-squares parabola through the data) and an RBF
kernel under Gamma hyperpriors, and the UCB / LCB acquisitions built on it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..gp.exact import GPConfig, GPState, fit_gp, posterior_mean_var, predict
from ..gp.fbgp import as_f32, device_of
from ..utils.prng import KeyRing
from ..utils.sobol import sobol_engine, sobol_sample


def _parabolic_fit(x: np.ndarray, y: np.ndarray):
    """Least-squares fit y ~ sum_j a_j x_j^2 + b_j x_j + c, with the
    reference's cases for one and two points (its trust-constr solve of
    the same linear problem, SOBER/BOLFI/_gpytorch_bolfi_model.py:392-446)."""
    n, d = x.shape
    if n == 1:
        return np.zeros(d), np.zeros(d), float(y[0])
    if n == 2:
        a = np.zeros(d)
        b = (y[1] - y[0]) / (x[1] - x[0])
        c = float(y[0] - np.sum(b * x[0]))
        return a, b, c
    design = np.concatenate([x**2, x, np.ones((n, 1))], axis=1)
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    return coef[:d], coef[d:2 * d], float(coef[-1])


def _host(a) -> np.ndarray:
    return np.asarray(torch.as_tensor(a).detach().cpu(), np.float64)


def bolfi_config(x, y, bounds, noise_lo: float = 1e-6, noise_hi: float = 1e2,
                 fit_iters: int = 100, manual_kernel: bool = False) -> GPConfig:
    """The BOLFI surrogate's GPConfig for the data (x, y) in `bounds`
    (BOLFIModel, SOBER/BOLFI/_gpytorch_bolfi_model.py:341-460), computed on
    the host in float64.

    The lengthscale prior is Gamma(range / 3, 1), the outputscale's
    Gamma((max y / 3)^2, 1); the parabolic mean's Normal priors come from
    the least-squares parabola with the reference's variance heuristics.
    `manual_kernel=True` takes the ARD RBF with one Gamma prior a
    lengthscale (BOLFIKernel_manually_implemented, :179-338)."""
    x_np, y_np, bounds_np = _host(x), _host(y).reshape(-1), _host(bounds)
    n, d = x_np.shape

    length_scale = float((bounds_np.max() - bounds_np.min()) / 3.0)
    kernel_var = max(float((y_np.max() / 3.0) ** 2), 1e-6)

    a, b, c = _parabolic_fit(x_np, y_np)
    # variance heuristics (SOBER/BOLFI/_gpytorch_bolfi_model.py:425-437)
    if n > 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            resid = (y_np[:, None] - b * x_np - c) / np.where(a == 0, 1.0, a)
            a_var = np.sum((np.sqrt(np.abs(resid)) - x_np) ** 2, axis=0)
    else:
        a_var = np.ones(d)
    b_var = (-b - 2 * a * x_np[np.argmin(y_np)]) ** 2
    c_var = float((c - y_np.min()) ** 2)
    a = np.maximum(a, 1e-4)  # the square coefficients stay positive

    ls_prior = ((length_scale,) * d, (1.0,) * d) if manual_kernel else (length_scale, 1.0)
    return GPConfig(
        kernel_name="rbf", ard=manual_kernel, noise_lo=noise_lo, noise_hi=noise_hi,
        train_lik=True, standardize_y=False, use_priors=True, ls_prior=ls_prior,
        os_prior=(kernel_var, 1.0), mean="parabolic",
        mean_priors=(tuple(float(v) for v in a),
                     tuple(float(max(v, 1e-6)) for v in a_var),
                     tuple(float(v) for v in b),
                     tuple(float(max(v, 1e-6)) for v in b_var),
                     c, max(c_var, 1e-6)),
        fit_iters=fit_iters)


def make_bolfi_model(x, y, bounds, noise_lo: float = 1e-6,
                     noise_hi: float = 1e2, optimiser: str = "lbfgs",
                     fit_iters: int = 100, manual_kernel: bool = False,
                     device=None) -> GPState:
    """The MAP-fitted BOLFI surrogate under `bolfi_config`, on the device of
    a tensor x, else on `device` (CUDA unless given)."""
    cfg = bolfi_config(x, y, bounds, noise_lo, noise_hi, fit_iters, manual_kernel)
    dev = device_of(x, device)
    return fit_gp(as_f32(x, dev), as_f32(y, dev), cfg, optimiser=optimiser)


def _bolfi_beta(sample_size: int, dim: int, exploration_rate: float) -> float:
    """BOLFI's UCB schedule (SOBER/BOLFI/_botorch_acquisition.py:43-48,
    118-124)."""
    t = max(sample_size, 1)
    return 2.0 * math.log(t ** (2 * dim + 2) * math.pi**2 / (3.0 / exploration_rate))


class SOBERUCB:
    """Pointwise UCB with the BOLFI beta schedule, the calc_obj of
    Sober.next_batch's recombination (SOBER/BOLFI/_botorch_acquisition.py:
    118-129)."""

    def __init__(self, model: GPState, label: str = "UCB",
                 sample_size: int = 1, exploration_rate: float = 10.0):
        self.label = label
        self.model = model
        self.beta = _bolfi_beta(sample_size, model.x.shape[1], exploration_rate)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mu, var = predict(self.model, x, include_noise=False)
        return mu + torch.sqrt(self.beta * var)


class BoTorchLCBSC:
    """LCB minimizer by sampled restarts and an Adam polish, the analogue of
    botorch's gen_batch_initial_conditions + gen_candidates_torch
    (SOBER/BOLFI/_botorch_acquisition.py:41-115)."""

    def __init__(self, model: GPState, bounds, prior=None,
                 exploration_rate: float = 10.0, constraints=None,
                 seed: int = 0):
        if prior is not None:
            raise NotImplementedError(
                "Priors for acquisition function not implemented.")
        self.model = model
        self.bounds = torch.as_tensor(bounds, dtype=torch.float32, device=model.x.device)
        self.exploration_rate = exploration_rate
        self.keys = KeyRing(seed, device=model.x.device)

    def _beta(self, t: Optional[int]) -> float:
        t = 0 if t is None else t
        return _bolfi_beta(t + 1, self.model.x.shape[1], self.exploration_rate)

    def evaluate(self, x: torch.Tensor, t: Optional[int] = None) -> torch.Tensor:
        """The negated LCB at x (to be maximized)."""
        mu, var = predict(self.model, x, include_noise=False)
        return -(mu - torch.sqrt(self._beta(t) * var))

    def _lcb(self, x: torch.Tensor, beta: float) -> torch.Tensor:
        mu, var = posterior_mean_var(self.model, x, include_noise=False)
        return mu - torch.sqrt(beta * var)

    def polish(self, x0: torch.Tensor, beta: float, polish_steps: int = 50) -> torch.Tensor:
        """Projected Adam descent of the summed LCB from the starts x0, at
        optax.adam's defaults (lr 0.05 * the widest box side, betas 0.9 and
        0.999, eps 1e-8), clipped into the box after every step."""
        lo, hi = self.bounds[0], self.bounds[1]
        lr = 0.05 * float(torch.max(hi - lo))
        x = x0.detach().clone()
        m, v = torch.zeros_like(x), torch.zeros_like(x)
        for t in range(1, polish_steps + 1):
            xg = x.requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(torch.sum(self._lcb(xg, beta)), xg)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9 ** t)
            vh = v / (1.0 - 0.999 ** t)
            x = xg.detach() - lr * mh / (torch.sqrt(vh) + 1e-8)
            x = torch.minimum(torch.maximum(x, lo[None, :]), hi[None, :])
        return x

    def acquire(self, n: int, t: Optional[int] = None,
                std_scale: Optional[float] = None,
                num_restarts: int = 25, polish_steps: int = 50) -> np.ndarray:
        """Minimize the LCB: the num_restarts lowest of min(500 * 2^d, 65536)
        Sobol points polished; returns the n best, (n, d) numpy."""
        beta = std_scale if std_scale is not None else self._beta(t)
        d = self.bounds.shape[1]
        lo, hi = self.bounds[0], self.bounds[1]
        n_raw = min(500 * 2**d, 65536)
        gen = self.keys.next()
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
        eng = sobol_engine(d, seed=seed, device=self.bounds.device)
        raw = lo + (hi - lo) * sobol_sample(eng, 0, n_raw)
        with torch.no_grad():
            _, top = torch.topk(-self._lcb(raw, beta), num_restarts)
        polished = self.polish(raw[top], beta, polish_steps)
        with torch.no_grad():
            _, best = torch.topk(-self._lcb(polished, beta), min(n, num_restarts))
        return polished[best].cpu().numpy()
