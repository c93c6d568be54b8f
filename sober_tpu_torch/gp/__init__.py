"""Gaussian-process surrogates of the port: the exact GP, the Tanimoto GP,
the fully-Bayesian GP (FBGP), the warped BQ model, the multitask GPs and
pathwise posterior sampling."""
from .exact import (GPConfig, GPParams, GPState, build_state, fit_gp,
                    fit_gp_padded, fit_params, init_params, mean_value, neg_mll,
                    pad_observations, polish_posterior_mean,
                    posterior_max_mean, predict, predict_mean, predict_raw,
                    predictive_covariance, raw_params_from_state)
from .fbgp import (FBGPAcquisitionFunction, FitboGP, FullyBayesianGP, PIFBGP,
                   RBFHyperPrior, ScaleVanillaGP, fbgp_refit, fitbo_mll,
                   fitbo_mll_batch, quadrature_distillation, sampling_hypers)
from .multitask import (ICMState, MultiTaskGPState, fit_icm_gp,
                        fit_multitask_gp, predict_icm, predict_multitask,
                        sample_icm, sample_multitask, task_posterior_cov_icm)
from .sampling import (RFFBasis, decoupled_sampler, joint_posterior_samples,
                       make_rff_basis)
from .tanimoto import batch_tanimoto_sim, fit_tanimoto_gp
from .warped import PIBQ, ScaleMmltGP

__all__ = ["FBGPAcquisitionFunction", "FitboGP", "FullyBayesianGP", "GPConfig",
           "GPParams", "GPState", "ICMState", "MultiTaskGPState", "PIBQ", "PIFBGP",
           "RBFHyperPrior", "RFFBasis", "ScaleMmltGP", "ScaleVanillaGP",
           "batch_tanimoto_sim", "build_state", "decoupled_sampler", "fbgp_refit",
           "fit_gp", "fit_gp_padded", "fit_icm_gp", "fit_multitask_gp", "fit_params",
           "fit_tanimoto_gp", "fitbo_mll", "fitbo_mll_batch", "init_params",
           "mean_value", "polish_posterior_mean", "raw_params_from_state",
           "joint_posterior_samples", "make_rff_basis", "neg_mll", "pad_observations",
           "posterior_max_mean", "predict", "predict_icm", "predict_mean",
           "predict_multitask", "predict_raw", "predictive_covariance",
           "quadrature_distillation", "sample_icm", "sample_multitask",
           "sampling_hypers", "task_posterior_cov_icm"]
