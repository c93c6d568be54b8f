"""Priors of the port (the dataset prior, for now)."""
from .base import BasePrior
from .dataset import DatasetPrior

__all__ = ["BasePrior", "DatasetPrior"]
