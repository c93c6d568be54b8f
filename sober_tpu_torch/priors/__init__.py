"""Priors of the port: the continuous proposals (TruncatedGaussian with its
Genz box probability and TMVN samplers among them), the discrete and mixed
priors, and the dataset prior."""
from .base import BasePrior
from .continuous import Gaussian, TruncatedGaussian, Uniform
from .dataset import DatasetPrior
from .discrete import (BinaryPrior, CategoricalPrior, MixedBinaryPrior,
                       MixedCategoricalPrior)
from .mvn_cdf import multivariate_normal_cdf, mvn_box_log_prob, mvn_box_prob
from .tmvn import TruncatedMVN
from .wkde import WeightedKernelDensityEstimation

__all__ = ["BasePrior", "BinaryPrior", "CategoricalPrior", "DatasetPrior",
           "Gaussian", "MixedBinaryPrior", "MixedCategoricalPrior",
           "TruncatedGaussian", "TruncatedMVN", "Uniform",
           "WeightedKernelDensityEstimation", "multivariate_normal_cdf",
           "mvn_box_log_prob", "mvn_box_prob"]
