"""Gaussian-process surrogates of the port: the exact GP, the Tanimoto GP,
the fully-Bayesian GP (FBGP) and the warped BQ model."""
from .exact import (GPConfig, GPParams, GPState, build_state, fit_gp,
                    fit_gp_padded, fit_params, init_params, neg_mll,
                    pad_observations, posterior_max_mean, predict,
                    predict_mean, predict_raw, predictive_covariance)
from .fbgp import (FBGPAcquisitionFunction, FitboGP, FullyBayesianGP, PIFBGP,
                   RBFHyperPrior, ScaleVanillaGP, fbgp_refit, fitbo_mll_batch,
                   quadrature_distillation, sampling_hypers)
from .tanimoto import batch_tanimoto_sim, fit_tanimoto_gp
from .warped import PIBQ, ScaleMmltGP

__all__ = ["FBGPAcquisitionFunction", "FitboGP", "FullyBayesianGP", "GPConfig",
           "GPParams", "GPState", "PIBQ", "PIFBGP", "RBFHyperPrior",
           "ScaleMmltGP", "ScaleVanillaGP", "batch_tanimoto_sim", "build_state",
           "fbgp_refit", "fit_gp", "fit_gp_padded", "fit_params",
           "fit_tanimoto_gp", "fitbo_mll_batch", "init_params", "neg_mll",
           "pad_observations", "posterior_max_mean", "predict", "predict_mean",
           "predict_raw", "predictive_covariance", "quadrature_distillation",
           "sampling_hypers"]
