"""Priors of the port: the continuous proposals, the discrete and mixed
priors, and the dataset prior."""
from .base import BasePrior
from .continuous import Gaussian, Uniform
from .dataset import DatasetPrior
from .discrete import (BinaryPrior, CategoricalPrior, MixedBinaryPrior,
                       MixedCategoricalPrior)
from .wkde import WeightedKernelDensityEstimation

__all__ = ["BasePrior", "BinaryPrior", "CategoricalPrior", "DatasetPrior",
           "Gaussian", "MixedBinaryPrior", "MixedCategoricalPrior", "Uniform",
           "WeightedKernelDensityEstimation"]
