"""Gaussian-process surrogates of the port (exact GP only, for now)."""
from .exact import (GPConfig, GPParams, GPState, build_state, fit_gp,
                    fit_gp_padded, fit_params, init_params, neg_mll,
                    pad_observations, posterior_max_mean, predict,
                    predictive_covariance)

__all__ = ["GPConfig", "GPParams", "GPState", "build_state", "fit_gp",
           "fit_gp_padded", "fit_params", "init_params", "neg_mll",
           "pad_observations", "posterior_max_mean", "predict",
           "predictive_covariance"]
