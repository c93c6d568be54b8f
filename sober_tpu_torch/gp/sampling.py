"""Pathwise GP posterior sampling, the decoupled (Matheron) sampler (port of
sober_tpu/gp/sampling.py; benchmarks/gp_sampling/ of the reference).

A posterior sample path is

    f_s(x) = Phi(x)^T w_s  +  k(x, X) (K + s^2 I)^-1 (y - Phi(X)^T w_s - e_s)

with a random-Fourier-feature prior basis Phi, w_s ~ N(0, I) and
e_s ~ N(0, s^2 I) (Wilson et al. 2020). The draws (`make_rff_basis`,
`path_draws`) are apart from the paths (`decoupled_paths`), so the same
frequencies and normals can be handed to both packages. On a padded state
e_s is drawn for the real rows only and the correction is zero on the
padding, so the paths are those of the same hypers on the real rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.linalg import jitter_cholesky
from .exact import GPState, predict, predictive_covariance


class RFFBasis(NamedTuple):
    omega: torch.Tensor        # (num_basis, d) frequencies
    phase: torch.Tensor        # (num_basis,)
    scale: torch.Tensor        # sqrt(2 * outputscale / num_basis)
    lengthscale: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(n, num_basis) feature matrix."""
        proj = (x / self.lengthscale) @ self.omega.T + self.phase[None, :]
        return self.scale * torch.cos(proj)


# Matern smoothness nu per kernel name, as the Student-t degrees of freedom
# 2 nu of its spectral measure (unit lengthscale): the characteristic
# function of the multivariate t is the Matern correlation
_MATERN_DF = {"matern12": 1, "matern32": 3, "matern52": 5}


def rff_basis(state: GPState, omega: torch.Tensor,
              phase: torch.Tensor) -> RFFBasis:
    """The basis of the state's fitted kernel on given frequencies."""
    os_ = state.kernel.params["outputscale"]
    scale = torch.sqrt(2.0 * os_ / omega.shape[0])
    return RFFBasis(omega, phase, scale, state.kernel.params["lengthscale"])


def make_rff_basis(gen: torch.Generator, state: GPState,
                   num_basis: int = 1024) -> RFFBasis:
    """Random Fourier features for the fitted stationary kernel: Gaussian
    frequencies for RBF, multivariate-t ones with df = 2 nu for Matern-nu,
    omega = z sqrt(df / u), u ~ chi2_df drawn exactly as the sum of df
    squared normals (the degrees of freedom are integers)."""
    name = state.kernel.name
    if name != "rbf" and name not in _MATERN_DF:
        raise ValueError(
            f"no spectral density registered for kernel {name!r}; "
            f"pathwise sampling supports rbf and {sorted(_MATERN_DF)}")
    dev = state.x.device
    omega = torch.randn((num_basis, state.x.shape[1]), generator=gen, device=dev)
    if name in _MATERN_DF:
        df = _MATERN_DF[name]
        u = torch.sum(torch.randn((num_basis, df), generator=gen, device=dev) ** 2, dim=1)
        omega = omega * torch.sqrt(df / torch.clamp_min(u, 1e-12))[:, None]
    phase = 2 * torch.pi * torch.rand((num_basis,), generator=gen, device=dev)
    return rff_basis(state, omega, phase)


def path_draws(gen: torch.Generator, state: GPState, n_samples: int,
               num_basis: int):
    """The weights w (n_samples, num_basis) and the unit normals of the
    noise draws (n_samples, n): zero on a padded state's padding rows,
    drawn for its real rows only."""
    dev = state.x.device
    w = torch.randn((n_samples, num_basis), generator=gen, device=dev)
    if state.mask is None:
        return w, torch.randn((n_samples, state.x.shape[0]), generator=gen, device=dev)
    real = state.mask > 0
    eps = torch.zeros((n_samples, state.x.shape[0]), device=dev)
    eps[:, real] = torch.randn((n_samples, int(real.sum())), generator=gen, device=dev)
    return w, eps


def decoupled_paths(state: GPState, basis: RFFBasis, w: torch.Tensor,
                    eps: torch.Tensor):
    """x -> (n_samples, n_x) joint posterior sample paths from the given
    basis, weights and unit noise normals."""
    phi_train = basis(state.x)                                    # (n, B)
    resid = state.y[None, :] - w @ phi_train.T - eps * torch.sqrt(state.noise)
    corr = torch.cholesky_solve(resid.T, state.chol).T           # (S, n)
    if state.mask is not None:
        corr = corr * state.mask[None, :]

    @torch.no_grad()
    def paths(xq: torch.Tensor) -> torch.Tensor:
        return w @ basis(xq).T + corr @ state.kernel.gram(state.x, xq)

    return paths


@torch.no_grad()
def decoupled_sampler(gen: torch.Generator, state: GPState, n_samples: int,
                      num_basis: int = 1024):
    """x -> (n_samples, n_x) joint posterior sample paths (the decoupled-TS
    sampler of benchmarks/_batch_bo.py:27-41)."""
    basis = make_rff_basis(gen, state, num_basis)
    return decoupled_paths(state, basis, *path_draws(gen, state, n_samples, num_basis))


@torch.no_grad()
def joint_samples_from_normals(state: GPState, xq: torch.Tensor,
                               z: torch.Tensor) -> torch.Tensor:
    """mu + z L^T over xq, L the jittered factor of the posterior
    covariance, for unit normals z (n_samples, n_xq)."""
    mu, _ = predict(state, xq, include_noise=False)
    chol, _ = jitter_cholesky(predictive_covariance(state, xq, xq))
    return mu[None, :] + z @ chol.T


def joint_posterior_samples(gen: torch.Generator, state: GPState,
                            xq: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Exact joint posterior samples over xq (for small pools), as
    botorch's MaxPosteriorSampling draws them (benchmarks/_batch_bo.py:20-25)."""
    z = torch.randn((n_samples, xq.shape[0]), generator=gen, device=xq.device)
    return joint_samples_from_normals(state, xq, z)
