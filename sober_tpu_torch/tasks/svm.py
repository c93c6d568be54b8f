"""SVM feature-selection task on a mixed binary + continuous domain (port
of sober_tpu/tasks/svm.py; experiments/_svm.py of the reference).

Select 20 features (a binary mask) and 3 SVR hyperparameters (epsilon, C
and gamma on log scales) to minimize the test RMSE of an SVR on the UCI
slice-localization data. The CSV is not vendored; without it a synthetic
sparse-regression set of the same shape stands in. The objective is host
code: scikit-learn is imported where an SVR is fitted, and pandas only
where the CSV is read.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..priors.discrete import MixedBinaryPrior

DATA_DIR = Path(__file__).resolve().parents[2] / "sober_tpu" / "tasks" / "data"
N_FEATURES = 20


def _synthetic_uci_like(n: int = 2000, n_cols: int = 50, seed: int = 0):
    """Sparse linear-plus-nonlinear regression data standing in for the UCI
    slice data when it is not at hand."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, n_cols))
    informative = rng.choice(n_cols, 8, replace=False)
    w = rng.normal(size=8)
    y = x[:, informative] @ w + 0.3 * np.sin(3 * x[:, informative[0]])
    y = y + 0.05 * rng.normal(size=n)
    return np.column_stack([x, y])


def _process_uci_data(data: np.ndarray, n_features: int, seed: int = 0):
    """Keep the n_features columns most correlated with the target and
    split 1000 shuffled rows 50/50 (the reference's process_uci_data)."""
    rng = np.random.default_rng(seed)
    x, y = data[:, :-1], data[:, -1]
    y = (y - y.mean()) / max(y.std(), 1e-12)
    corr = np.abs(np.array([
        np.corrcoef(x[:, j], y)[0, 1] if x[:, j].std() > 0 else 0.0
        for j in range(x.shape[1])]))
    keep = np.argsort(-corr)[:n_features]
    x = x[:, keep]
    n = min(len(x), 1000)
    perm = rng.permutation(len(x))[:n]
    x, y = x[perm], y[perm]
    half = n // 2
    return x[:half], y[:half], x[half:], y[half:]


class SVMFeatureSelection:
    """(experiments/_svm.py:220-268)"""

    def __init__(self, dim: int, data: np.ndarray):
        self.n_features = dim - 3
        self.dim = dim
        (self.train_x, self.train_y,
         self.test_x, self.test_y) = _process_uci_data(data, self.n_features)

    def _evaluate_true(self, x: np.ndarray) -> float:
        from sklearn.svm import SVR

        inds = np.flatnonzero(x[: self.n_features] >= 0.5)
        if len(inds) == 0:
            pred = np.full_like(self.test_y, self.train_y.mean())
        else:
            epsilon = 0.01 * 10 ** (2 * x[-3])
            c = 0.01 * 10 ** (4 * x[-2])
            gamma = (1 / self.n_features) * 0.1 * 10 ** (2 * x[-1])
            model = SVR(C=c, epsilon=epsilon, gamma=gamma)
            model.fit(self.train_x[:, inds], self.train_y)
            pred = model.predict(self.test_x[:, inds])
        return math.sqrt(float(((pred - self.test_y) ** 2).mean()))

    def __call__(self, x) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x))
        return np.array([self._evaluate_true(row) for row in x])


def setup_svm(data_path: Optional[str] = None, seed: int = 0, device=None):
    """20 binary feature masks and 3 continuous hypers on [0, 1], binary
    block first (experiments/_svm.py:270-310), the prior on `device` (CUDA
    unless given). Maximization convention: the negated RMSE, on the
    device of the rows it is given."""
    device = resolve_device(device)
    n_dims_cont, n_dims_binary = 3, N_FEATURES
    path = Path(data_path or DATA_DIR / "slice_localization_data.csv")
    if path.exists():
        import pandas as pd

        data = np.asarray(pd.read_csv(path))
    else:
        data = _synthetic_uci_like(seed=seed)
    svm = SVMFeatureSelection(n_dims_cont + n_dims_binary, data)
    bounds = np.stack([np.zeros(n_dims_cont), np.ones(n_dims_cont)])
    prior = MixedBinaryPrior(n_dims_cont, n_dims_binary, bounds,
                             continous_first=False, device=device)

    def test_function(x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(-svm(x.detach().cpu().numpy()), dtype=torch.float32,
                               device=x.device)

    return prior, test_function
