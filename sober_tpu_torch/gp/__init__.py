"""Gaussian-process surrogates of the port (exact GP only, for now)."""
from .exact import (GPConfig, GPParams, GPState, build_state, fit_gp,
                    fit_gp_padded, fit_params, init_params, neg_mll,
                    pad_observations, posterior_max_mean, predict,
                    predict_mean, predict_raw, predictive_covariance)
from .tanimoto import batch_tanimoto_sim, fit_tanimoto_gp

__all__ = ["GPConfig", "GPParams", "GPState", "batch_tanimoto_sim",
           "build_state", "fit_gp", "fit_gp_padded", "fit_params",
           "fit_tanimoto_gp", "init_params", "neg_mll", "pad_observations",
           "posterior_max_mean", "predict", "predict_mean", "predict_raw",
           "predictive_covariance"]
