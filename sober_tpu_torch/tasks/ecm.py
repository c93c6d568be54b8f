"""The equivalent-circuit (ECM) battery impedance simulator for
simulation-based inference (port of sober_tpu/tasks/ecm.py;
experiments/_ecm.py): a canonical model of two RC pairs, evaluated on a
batch of parameter rows at once."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device
from ..priors.continuous import TruncatedGaussian


class CanonicalECMTwoRCs:
    """The two-RC-pair canonical ECM (experiments/_ecm.py:10-174), on
    `device` (CUDA unless given).

    Parameters theta = (rt, r1_, t1, r2_, t2): the log total resistance,
    the doubly log-warped AC resistance fractions and the normalized log
    time constants. The observed spectrum is the true one plus Gaussian
    noise of variance exp(-exp(sigma)), drawn on the CPU from a torch
    generator seeded with `seed`, so the observations depend on the seed
    and not on the device (the JAX package's threefry draw cannot be
    reproduced here; interop.ecm_from_numpy carries its observations
    across)."""

    def __init__(self, rt, r1_, t1, r2_, t2, sigma, omega, seed: int = 0,
                 device=None):
        device = resolve_device(device)
        self.omega = torch.as_tensor(omega, dtype=torch.float32, device=device)
        self.device = self.omega.device
        self.noise_sig = float(sigma)
        log_omega = torch.log(self.omega)
        self.mu = torch.mean(log_omega)
        self.sigma = torch.std(log_omega, correction=0)
        self.theta_true = torch.tensor([rt, r1_, t1, r2_, t2], dtype=torch.float32,
                                       device=device)
        # the synthetic observations (experiments/_ecm.py:87-93)
        re, im = self._spectrum(self.theta_true[None, :])
        gen = torch.Generator().manual_seed(seed)
        n = self.omega.shape[0]
        sd = math.sqrt(math.exp(-math.exp(self.noise_sig)))
        self.reZ = re[0] + torch.randn(n, generator=gen).to(self.device) * sd
        self.imZ = im[0] + torch.randn(n, generator=gen).to(self.device) * sd

    def _normalised_input(self, tau: torch.Tensor) -> torch.Tensor:
        """(B,) time constants -> (B, n) normalized log frequencies."""
        return torch.log(self.omega)[None, :] - (self.sigma * tau[:, None] + self.mu)

    def _spectrum(self, theta: torch.Tensor):
        """The real and imaginary impedance spectra (B, n) of theta (B, 5)."""
        rt, r1_, t1, r2_, t2 = theta.unbind(dim=1)
        r1 = torch.exp(-torch.exp(r1_))[:, None]
        r2 = torch.exp(-torch.exp(r2_))[:, None]
        r0 = 1.0 - r1 - r2
        big_rt = torch.exp(rt)[:, None]
        z1 = self._normalised_input(t1)
        z2 = self._normalised_input(t2)
        re = big_rt * (r0 + r1 / 2 * (1 - torch.tanh(z1)) + r2 / 2 * (1 - torch.tanh(z2)))
        im = big_rt * ((r1 / 2) / torch.cosh(z1) + (r2 / 2) / torch.cosh(z2))
        return re, im

    def convert_circuit_elements(self, theta):
        """(R0, R1, C1, R2, C2) in physical units of one theta (5,)
        (experiments/_ecm.py:114-128)."""
        rt, r1_, t1, r2_, t2 = torch.as_tensor(theta, dtype=torch.float32,
                                               device=self.device).unbind()
        r1 = torch.exp(-torch.exp(r1_))
        r2 = torch.exp(-torch.exp(r2_))
        big_rt = torch.exp(rt)
        r0v = big_rt * (1 - r1 - r2)
        r1v, r2v = big_rt * r1, big_rt * r2
        c1 = torch.exp(-(self.sigma * t1 + self.mu)) / r1v
        c2 = torch.exp(-(self.sigma * t2 + self.mu)) / r2v
        return r0v, r1v, c1, r2v, c2

    def __call__(self, theta_batch):
        """(discrepancy, loglikelihood), each (B,), of theta rows (B, 5) or
        one theta (5,) (experiments/_ecm.py:164-174)."""
        theta = torch.atleast_2d(torch.as_tensor(theta_batch, dtype=torch.float32,
                                                 device=self.device))
        re, im = self._spectrum(theta)
        err = (torch.sum((self.reZ[None, :] - re) ** 2, dim=1)
               + torch.sum((self.imZ[None, :] - im) ** 2, dim=1))
        n = 2 * self.omega.shape[0]
        r = err / n
        discrepancy = -torch.log(r)
        loglik = -0.5 * torch.log(2 * math.pi * r) * n - 0.5 * err / r
        return discrepancy, loglik


def setup_ecm_two(seed: int = 0, device=None):
    """(experiments/_ecm.py:176-203): a truncated-Gaussian prior over the 5
    ECM parameters and the batched (discrepancy, loglikelihood) simulator,
    on `device` (CUDA unless given)."""
    device = resolve_device(device)
    omega = (2 * np.pi * np.logspace(1, 10, 100)).astype(np.float32)
    params_true = np.array([2.0, -0.5, -1.0, 0.0, 0.5])
    sim = CanonicalECMTwoRCs(*params_true.tolist(), sigma=1.0, omega=omega, seed=seed,
                             device=device)
    bounds = [[1.0, -2.0, -2.0, -2.0, -2.0], [3.0, 2.0, 2.0, 2.0, 2.0]]
    prior = TruncatedGaussian(params_true * 0.9, 0.5 * np.eye(5), bounds, device=device)
    return prior, sim
