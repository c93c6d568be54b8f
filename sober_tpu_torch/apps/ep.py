"""Expectation propagation over the features of the data (port of
sober_tpu/apps/ep.py; SOBER/_expectation_propagation.py).

Feature by feature, each EP site is visited with a full SOBER and BASQ
round against the distance of that one feature; the site's natural
parameters (Q, r) are updated with dampening, and the working prior is
rebuilt as a TruncatedGaussian at +-1.95 sd around the current posterior.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..priors.continuous import TruncatedGaussian
from .wrapper import SoberWrapper


class ExpectationPropagation(SoberWrapper):
    def __init__(self, model, data, feature_extractor: Callable,
                 model_initial_samples: int = 0, mean=None, covariance=None,
                 bounds=None, use_bolfi: bool = False, transforms=None,
                 seed: Optional[int] = None, disable_numpy_mode: bool = False,
                 parallelization: bool = True, visualizations: bool = False,
                 true_optimum=None, device=None, **kwargs):
        """(SOBER/_expectation_propagation.py:10-134)

        feature_extractor maps one observation (a numpy row) to a list of
        features; each feature is one EP site. `device` as SoberWrapper's."""
        super().__init__(
            model=model, data=data, model_initial_samples=model_initial_samples,
            mean=mean, covariance=covariance, bounds=bounds, prior="TruncatedGaussian",
            maximize=False, use_bolfi=use_bolfi, weights=None,
            custom_objective_and_loglikelihood=None, transforms=transforms, seed=seed,
            disable_numpy_mode=disable_numpy_mode, parallelization=parallelization,
            visualizations=visualizations, true_optimum=true_optimum, standalone=False,
            device=device, **kwargs)

        self.normalized_mean = self.prior.mu
        self.normalized_covariance = self.prior.cov

        self.feature_extractor = feature_extractor
        self.experimental_features = self.feature_extractor(self.data.cpu().numpy())
        self.feature_dim = len(self.experimental_features)
        self.current_feature = 0

        # the exponential family's natural parameters: mu = Q^-1 r,
        # Sigma = Q^-1 (SOBER/_expectation_propagation.py:125-134)
        self.Q = torch.linalg.inv(self.normalized_covariance)
        self.r = self.Q @ self.normalized_mean
        self.Q_features = [torch.zeros_like(self.Q) for _ in range(self.feature_dim)]
        self.r_features = [torch.zeros_like(self.r) for _ in range(self.feature_dim)]

    def distance_function(self, observations):
        """The distance of the CURRENT feature only
        (SOBER/_expectation_propagation.py:136-146); observations are rows,
        a tensor or an array."""
        obs = (observations.cpu().numpy() if isinstance(observations, torch.Tensor)
               else np.asarray(observations))
        target = np.asarray(self.experimental_features[self.current_feature])
        dists = [np.linalg.norm(np.atleast_1d(
            np.asarray(self.feature_extractor(row)[self.current_feature]) - target))
            for row in obs]
        return torch.as_tensor(np.asarray(dists, np.float32), device=self.device)

    def run_Expectation_Propagation(self, ep_iterations: int = 3,
                                    final_dampening: float = 0.5, **kwargs):
        """(SOBER/_expectation_propagation.py:148-204) Keyword arguments go
        to run_SOBER and run_BASQ."""
        ep_dampener = 1.0 - self.feature_dim * (
            1.0 - final_dampening ** (1.0 / (self.feature_dim * ep_iterations)))

        for _ in range(ep_iterations):
            for i in range(self.feature_dim):
                self.current_feature = i
                self.initialize_sober()
                self.run_SOBER(**kwargs)
                taken_samples, *_ = self.run_BASQ(return_raw_samples=True, **kwargs)
                interim_mean = torch.mean(taken_samples, dim=0)
                interim_cov = torch.atleast_2d(torch.cov(taken_samples.T))
                q_interim = torch.linalg.inv(interim_cov)
                r_interim = q_interim @ interim_mean
                self.Q_features[i] = self.Q_features[i] + (1 - ep_dampener) * (
                    q_interim - self.Q)
                self.r_features[i] = self.r_features[i] + (1 - ep_dampener) * (
                    r_interim - self.r)
                self.Q = (1 - ep_dampener) * q_interim + ep_dampener * self.Q
                self.r = (1 - ep_dampener) * r_interim + ep_dampener * self.r
                post_cov = torch.linalg.inv(self.Q)
                post_mean = post_cov @ self.r
                sd = torch.sqrt(torch.diag(post_cov))
                post_bounds = torch.stack([post_mean - 1.95 * sd, post_mean + 1.95 * sd])
                self.prior = TruncatedGaussian(post_mean, post_cov, post_bounds,
                                               device=self.device)
