"""Priors of the port: the continuous proposals and the dataset prior."""
from .base import BasePrior
from .continuous import Gaussian, Uniform
from .dataset import DatasetPrior
from .wkde import WeightedKernelDensityEstimation

__all__ = ["BasePrior", "DatasetPrior", "Gaussian", "Uniform",
           "WeightedKernelDensityEstimation"]
