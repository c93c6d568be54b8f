"""Warped GP models for Bayesian quadrature (port of sober_tpu/gp/warped.py;
ScaleMmltGP, SOBER/BASQ/_scale_mmlt.py).

Observed y are log-likelihoods; the model fits h = log(exp(y - beta) + 1)
with beta = max(y), and moment-matches predictions back to g-space:

      f space    |        g space          |   h space
      f = g e^b  |   g = exp(h) - 1        |   h ~ GP
  mu_f = mu_g e^b| mu_g = e^{mu_h+s_h/2}-1 |   mu_h
                 | k_g = mu_g(x)mu_g(y)(e^{k_h(x,y)}-1)

(table: SOBER/BASQ/_scale_mmlt.py:28-37). The h-space GP's Grams reach the
RBF kernel through gp.exact on the card.
"""
from __future__ import annotations

import torch

from ..core.pi import normal_cdf
from ..utils.linalg import remove_anomalies
from .exact import GPConfig, GPState, fit_gp, predict, predictive_covariance
from .fbgp import EPS, as_f32, device_of


class ScaleMmltGP:
    """Scale-MMLT warped BQ model (SOBER/BASQ/_scale_mmlt.py:7-275)."""

    is_bq = True

    def __init__(self, x_obs, y_log, kernel_name: str = "rbf",
                 lik: float = 1e-10, rng: float = 10.0,
                 train_lik: bool = False, optimiser: str = "lbfgs",
                 fit_iters: int = 200, device=None):
        self.kernel_name = kernel_name
        self.cfg = GPConfig(
            kernel_name=kernel_name, noise_lo=lik / rng, noise_hi=lik * rng,
            train_lik=train_lik, standardize_y=False, use_priors=False,
            fit_iters=fit_iters)
        self.optimiser = optimiser
        self.jitter = 0.0
        device = device_of(x_obs, device)
        self.y_log = as_f32(y_log, device).reshape(-1)
        self._refit(as_f32(x_obs, device), self.y_log)

    # -- warps ---------------------------------------------------------------

    def _warp(self, y_log):
        """f (log) -> h, with the beta rescaling
        (process_y_warping_with_scaling, _scale_mmlt.py:88-101)."""
        y = remove_anomalies(y_log)
        self.beta = torch.max(y)
        return torch.log(torch.exp(y - self.beta) + 1.0)

    @staticmethod
    def warp_from_g_to_h(y_g):
        return torch.log(y_g + 1.0)

    @staticmethod
    def unwarp_from_h_to_g(y_h):
        return torch.exp(y_h) - 1.0

    def _refit(self, x, y_log):
        self.model: GPState = fit_gp(x, self._warp(y_log), self.cfg,
                                     optimiser=self.optimiser)

    # -- updates -------------------------------------------------------------

    def update(self, x_new, y_log_new):
        """Append observations and refit
        (update_mmlt_gp_with_scaling, _scale_mmlt.py:146-165)."""
        dev = self.model.x.device
        x_all = torch.cat([self.model.x, as_f32(x_new, dev)])
        self.y_log = torch.cat([self.y_log, as_f32(y_log_new, dev).reshape(-1)])
        self._refit(x_all, self.y_log)

    def retrain(self):
        """(retrain_gp_with_scaling, _scale_mmlt.py:167-182)"""
        self._refit(self.model.x, self.y_log)

    def memorise_parameters(self):
        self._memory = (self.model.kernel, self.model.noise)

    def remind_parameters(self):
        kernel, noise = self._memory
        self.model = self.model._replace(kernel=kernel, noise=noise)

    # -- prediction ----------------------------------------------------------

    def hspace_predict(self, x):
        return predict(self.model, x)

    def gspace_predict(self, x):
        """Moment-matched g-space prediction (_scale_mmlt.py:209-221)."""
        return _gspace_predict(self.model, x)

    def hspace_mean_predict(self, x):
        return self.hspace_predict(x)[0]

    def gspace_mean_predict(self, x):
        return self.gspace_predict(x)[0]

    def hspace_kernel(self, x, y):
        return predictive_covariance(self.model, x, y)

    def gspace_kernel(self, x, y):
        """g-space Gram (_scale_mmlt.py:256-275)."""
        return _gspace_apply(self.model, x, y)

    # -- Sober wiring --------------------------------------------------------

    def make_pi(self):
        return PIBQ(self)

    def rc_kernel(self):
        """The g-space kernel of this fit, the recombination kernel of Sober
        with this model."""
        state = self.model
        return lambda x, y: _gspace_apply(state, x, y)


def _gspace_predict(state: GPState, x):
    mu_h, var_h = predict(state, x)
    mu_g = torch.exp(mu_h + 0.5 * var_h) - 1.0
    return mu_g, mu_g ** 2 * (torch.exp(var_h) - 1.0)


def _gspace_apply(state: GPState, x, y):
    mu_g_x = _gspace_predict(state, x)[0]
    mu_g_y = mu_g_x if y is x else _gspace_predict(state, y)[0]
    cov_h = predictive_covariance(state, x, y)
    return mu_g_x[:, None] * mu_g_y[None, :] * (torch.exp(cov_h) - 1.0)


class PIBQ:
    """pi for BQ models: LFI against the g-space threshold 1
    (PI_BQ, SOBER/_pi.py:109-157)."""

    def __init__(self, model: ScaleMmltGP, label: str = "lfi"):
        self.model = model
        self.label = label

    def __call__(self, x_cand, log: bool = False):
        mu_g, var_g = _gspace_predict(self.model.model, x_cand)
        val = normal_cdf((mu_g - 1.0) / torch.sqrt(torch.clamp_min(var_g, 1e-30)))
        return torch.log(val + EPS) if log else val
