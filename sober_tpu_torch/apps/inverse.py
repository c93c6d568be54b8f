"""Inverse modelling: an observations -> parameters surrogate trained on
SOBER-chosen data (port of sober_tpu/apps/inverse.py;
SOBER/_inverse_modelling.py).

The objective is active learning: minimize the inverse model's predictive
uncertainty (objective = -sum log variance), the inverse surrogate refit
after every batch. The surrogates and the acquisition run on the
wrapper's device; the black-box model is host code, as in SoberWrapper.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from scipy.stats import chi2

from ..core.sober import Sober
from ..gp.multitask import (ICMState, MultiTaskGPState, fit_icm_gp,
                            fit_multitask_gp, predict_icm, predict_multitask,
                            sample_icm, sample_multitask, task_posterior_cov_icm)
from .wrapper import SoberWrapper


class InverseModel(SoberWrapper):
    def __init__(self, model, model_initial_samples: int = 0, mean=None,
                 covariance=None, bounds=None, use_bolfi: bool = False,
                 transforms=None, seed: Optional[int] = None,
                 disable_numpy_mode: bool = False,
                 parallelization: bool = True,
                 visualizations: bool = False,
                 task_covariance: str = "icm", icm_ard: bool = False,
                 icm_kernel: str = "rbf", device=None, **kwargs):
        """(SOBER/_inverse_modelling.py:16-118)

        task_covariance: "icm" (default) fits the intrinsic-coregionalization
        surrogate with a learned T x T task covariance (the reference's
        KroneckerMultiTaskGP); "independent" fits one GP a parameter.
        icm_ard / icm_kernel go to fit_icm_gp (icm_ard=True with
        icm_kernel="matern52" is botorch's ARD-Matern default). `device`:
        where the surrogates live (CUDA unless given)."""
        if task_covariance not in ("icm", "independent"):
            raise ValueError('task_covariance must be "icm" or "independent"')
        self.task_covariance = task_covariance
        self.icm_ard = icm_ard
        self.icm_kernel = icm_kernel
        super().__init__(
            model=model, data=None, model_initial_samples=model_initial_samples,
            mean=mean, covariance=covariance, bounds=bounds, prior="Uniform",
            maximize=False, use_bolfi=use_bolfi, weights=None,
            custom_objective_and_loglikelihood=None, transforms=transforms,
            seed=seed, disable_numpy_mode=disable_numpy_mode,
            parallelization=parallelization, visualizations=visualizations,
            true_optimum=None, standalone=False, device=device, **kwargs)
        self.observations_all = None
        self.observations_all_mean = None
        self.observations_all_std = None
        self.inverse_model: Optional[MultiTaskGPState | ICMState] = None
        self.update_training_data(initialization=True)
        self.results = []
        self.total_sober_iterations = 0
        self.total_model_samples = []

    # -- inverse surrogate ---------------------------------------------------

    def process_evaluations(self, evaluations, sober_batch):
        """Accumulate the observations and refit the inverse model
        (SOBER/_inverse_modelling.py:120-144)."""
        if not sober_batch:
            return
        evaluations = torch.atleast_2d(evaluations)
        if self.observations_all is None:
            obs = evaluations
        else:
            denorm = self.observations_all_mean + self.observations_all_std * self.observations_all
            obs = torch.cat([denorm, evaluations])
        self.observations_all_mean = obs.mean(dim=0)
        self.observations_all_std = torch.clamp_min(obs.std(dim=0, correction=0), 1e-12)
        self.observations_all = (obs - self.observations_all_mean) / self.observations_all_std
        self.optimize_inverse_model()

    def optimize_inverse_model(self):
        """Refit observations -> parameters (SOBER/_inverse_modelling.py:159-186)."""
        if self.task_covariance == "icm":
            self.inverse_model = fit_icm_gp(self.observations_all, self.X_all,
                                            ard=self.icm_ard, kernel=self.icm_kernel)
        else:
            self.inverse_model = fit_multitask_gp(self.observations_all, self.X_all)

    def default_objective_function(self, observations):
        """-sum log inverse-model variance (SOBER/_inverse_modelling.py:146-157)."""
        _, var = self(torch.atleast_2d(observations))
        return -torch.sum(torch.log(torch.clamp_min(var, 1e-30)), dim=1)

    def update_training_data(self, initialization: bool = False):
        """(SOBER/_inverse_modelling.py:188-200)"""
        self.Y_all, self.LL_all = self.objective_and_loglikelihood_function(
            self.X_all, sober_batch=initialization)
        self.Y_all_mean = self.Y_all.mean()
        self.Y_all_std = torch.clamp_min(self.Y_all.std(), 1e-12)
        self.Y_all = (self.Y_all - self.Y_all_mean) / self.Y_all_std
        self.weights = 1.0
        self.set_rbf_model(self.X_all, self.Y_all, use_bolfi=self.use_bolfi)
        self.sober = Sober(self.prior, self.surrogate_model)

    def optimize_inverse_model_with_SOBER(
            self, stopping_criterion_variance: float = 0.1,
            adaptive_batchsize_tolerance: float = 0.1,
            sober_iterations_per_convergence_check: int = 1,
            sober_iterations_per_training_data_updates: int = 1,
            maximum_number_of_batches: int = 10, **kwargs):
        """SOBER-driven training-data generation
        (SOBER/_inverse_modelling.py:202-253)."""
        if kwargs.get("sober_iterations"):
            maximum_number_of_batches = kwargs["sober_iterations"]
        kwargs["sober_iterations"] = 1
        for n_iter in range(maximum_number_of_batches):
            self.run_SOBER(**kwargs)
            if not n_iter % sober_iterations_per_convergence_check:
                *_, log_variance = self.run_BASQ(**kwargs)
                if math.exp(log_variance) < stopping_criterion_variance:
                    break
            if not n_iter % sober_iterations_per_training_data_updates:
                self.update_training_data()

    # -- prediction ----------------------------------------------------------

    def _normalized(self, observations) -> torch.Tensor:
        obs = torch.as_tensor(observations, dtype=torch.float32, device=self.device)
        return torch.atleast_2d((obs - self.observations_all_mean) / self.observations_all_std)

    def __call__(self, observations):
        """The inverse prediction, (mean, var) in the normalized parameter
        space (SOBER/_inverse_modelling.py:339-356)."""
        obs = self._normalized(observations)
        if isinstance(self.inverse_model, ICMState):
            return predict_icm(self.inverse_model, obs)
        return predict_multitask(self.inverse_model, obs)

    def evaluate(self, observations, confidence: float = 0.95,
                 one_dimensional_confidence: bool = False,
                 normalized_space: bool = False):
        """Mean, covariance and chi2 confidence bounds
        (SOBER/_inverse_modelling.py:255-305)."""
        dof = 1 if one_dimensional_confidence else self.input_dim
        deviations = chi2(dof).ppf(confidence) ** 0.5
        mean, var = self(observations)
        sd = torch.sqrt(torch.clamp_min(var, 0.0))
        lower, upper = mean - deviations * sd, mean + deviations * sd
        if isinstance(self.inverse_model, ICMState):
            # the learned cross-parameter covariance, which the independent
            # surrogate cannot give
            covariance = task_posterior_cov_icm(self.inverse_model,
                                                self._normalized(observations))
        else:
            covariance = torch.diag_embed(var)
        if not normalized_space:
            mean, lower, upper = (self.reverse_transform(self.denormalize_input(v))
                                  for v in (mean, lower, upper))
        return mean, covariance, (lower, upper)

    def sample(self, observations, sample_size: int, normalized_space: bool = False):
        """Posterior draws of the inverse prediction, (sample_size, m, d)
        (SOBER/_inverse_modelling.py:307-337)."""
        obs = self._normalized(observations)
        draw = sample_icm if isinstance(self.inverse_model, ICMState) else sample_multitask
        samples = draw(self.inverse_model, self.keys.next(), obs, sample_size)
        if not normalized_space:
            s, m, d = samples.shape
            flat = self.reverse_transform(self.denormalize_input(samples.reshape(s * m, d)))
            samples = flat.reshape(s, m, d)
        return samples
