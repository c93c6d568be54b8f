"""Discrete-domain benchmark tasks: pest control, MaxSAT and Ising
sparsification (port of sober_tpu/tasks/discrete.py; experiments/_pest.py,
_maxsat.py, _ising.py).

MaxSAT and Ising are batched tensor computations on the inputs' device;
the pest-control simulator is a stochastic host simulator in numpy, a black
box as in the reference. The MaxSAT instance is the JAX package's own file,
read from `sober_tpu/tasks/data/` without importing that package.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..priors.discrete import BinaryPrior, CategoricalPrior

DATA_DIR = Path(__file__).resolve().parents[2] / "sober_tpu" / "tasks" / "data"

# ----------------------------------------------------------------------------
# Pest control (experiments/_pest.py:10-195)
# ----------------------------------------------------------------------------

PESTCONTROL_N_CHOICE = 5
PESTCONTROL_N_STAGES = 15


def _pest_control_score(x: np.ndarray, seed: Optional[int] = 0) -> float:
    """(experiments/_pest.py:67-116). Lower is better."""
    u = 0.1
    n_stages = x.size
    n_sim = 100
    rng = np.random.RandomState(seed)

    init_alpha, init_beta = 1.0, 30.0
    spread_alpha, spread_beta = 1.0, 17.0 / 3.0
    control_alpha = 1.0
    control_price_max_discount = {1: 0.2, 2: 0.3, 3: 0.3, 4: 0.0}
    tolerance_develop_rate = {1: 1 / 7, 2: 2.5 / 7, 3: 2 / 7, 4: 0.5 / 7}
    control_price = {1: 1.0, 2: 0.8, 3: 0.7, 4: 0.5}
    control_beta = {1: 2 / 7, 2: 3 / 7, 3: 3 / 7, 4: 5 / 7}

    payed_price_sum = 0.0
    above_threshold = 0.0
    curr = rng.beta(init_alpha, init_beta, size=n_sim)
    for i in range(n_stages):
        spread_rate = rng.beta(spread_alpha, spread_beta, size=n_sim)
        xi = int(x[i])
        if xi > 0:
            control_rate = rng.beta(control_alpha, control_beta[xi], size=n_sim)
            nxt = (1.0 - control_rate) * curr
            control_beta[xi] += tolerance_develop_rate[xi] / n_stages
            payed = control_price[xi] * (
                1.0 - control_price_max_discount[xi] / n_stages
                * float(np.sum(x == xi)))
        else:
            nxt = spread_rate * (1 - curr) + curr
            payed = 0.0
        payed_price_sum += payed
        above_threshold += float(np.mean(curr > u))
        curr = nxt
    return payed_price_sum + above_threshold


class PestControl:
    """(experiments/_pest.py:119-164)"""

    def __init__(self, random_seed: int = 0):
        self.seed = random_seed
        self.dim = PESTCONTROL_N_STAGES

    def compute(self, x) -> np.ndarray:
        x = np.atleast_2d(np.asarray(x)).astype(int)
        res = np.array([_pest_control_score(row, seed=self.seed) for row in x])
        return res + 1e-6 * np.random.default_rng(0).normal(size=res.shape)


def setup_pest(device=None):
    """15 categorical stages x 5 pesticide choices
    (experiments/_pest.py:165-195), maximization convention (negated).
    The objective runs on the host and returns its values on the inputs'
    device."""
    categories = [[float(c) for c in range(PESTCONTROL_N_CHOICE)]] * PESTCONTROL_N_STAGES
    prior = CategoricalPrior(categories, device=device)
    pest = PestControl()

    def test_function(x: torch.Tensor) -> torch.Tensor:
        y = -pest.compute(x.detach().cpu().numpy())
        return torch.as_tensor(y, dtype=torch.float32, device=x.device)

    return prior, test_function


# ----------------------------------------------------------------------------
# MaxSAT (experiments/_maxsat.py)
# ----------------------------------------------------------------------------

class MaxSAT:
    """Weighted MaxSAT over a .wcnf file, evaluated for a batch at once:
    clauses padded to a fixed arity, the weights standardized as the
    reference does at load time."""

    def __init__(self, data_path, device=None):
        device = resolve_device(device)
        clauses, weights, n_vars = [], [], 0
        with open(data_path) as f:
            for line in f:
                if line.startswith(("c", "p")):
                    if line.startswith("p"):
                        n_vars = int(line.split()[2])
                    continue
                toks = line.split()
                if not toks:
                    continue
                weights.append(float(toks[0]))
                clauses.append([int(t) for t in toks[1:] if int(t) != 0])
        self.n_variables = n_vars
        w = np.array(weights, np.float32)
        w = (w - w.mean()) / max(w.std(), 1e-12)
        arity = max(len(c) for c in clauses)
        idx = np.zeros((len(clauses), arity), np.int64)
        sign = np.zeros((len(clauses), arity), np.float32)  # +1/-1; 0 = padding
        for i, lits in enumerate(clauses):
            for j, lit in enumerate(lits):
                idx[i, j] = abs(lit) - 1
                sign[i, j] = 1.0 if lit > 0 else -1.0
        self.weights = torch.as_tensor(w, device=device)
        self.idx = torch.as_tensor(idx, device=device)
        self.sign = torch.as_tensor(sign, device=device)

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, n_vars) in {0, 1}. The negated weighted count of
        satisfied clauses (lower is better, the reference's convention,
        experiments/_maxsat.py:83-89)."""
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        vals = x[:, self.idx]                                   # (b, C, A)
        lit_sat = torch.where(self.sign[None] > 0, vals > 0.5, vals < 0.5)
        lit_sat = lit_sat & (self.sign[None] != 0)
        satisfied = torch.any(lit_sat, dim=2).to(torch.float32)
        return -(satisfied @ self.weights.to(x.device))


def setup_maxsat(data_path=None, device=None):
    """28-variable weighted MaxSAT (experiments/_maxsat.py:95-123)."""
    maxsat = MaxSAT(data_path or DATA_DIR / "maxcut-johnson8-2-4.clq.wcnf",
                    device=device)
    prior = BinaryPrior(maxsat.n_variables, device=device)

    def test_function(x: torch.Tensor) -> torch.Tensor:
        return -maxsat.evaluate(x)            # maximize the satisfied weight

    return prior, test_function


# ----------------------------------------------------------------------------
# Ising sparsification (experiments/_ising.py)
# ----------------------------------------------------------------------------

ISING_GRID_H = 4
ISING_GRID_W = 4
ISING_N_EDGES = 24

_HORIZONTAL_IND = np.asarray([0, 2, 4, 7, 9, 11, 14, 16, 18, 21, 22, 23])
_VERTICAL_IND = np.asarray([i for i in range(ISING_N_EDGES)
                            if i not in set(_HORIZONTAL_IND.tolist())])


def _all_spin_configs(n: int, device) -> torch.Tensor:
    """(2^n, n) matrix of +/-1 spins."""
    ints = torch.arange(2 ** n, dtype=torch.int64, device=device)
    bits = (ints[:, None] >> torch.arange(n, dtype=torch.int64, device=device)[None, :]) & 1
    return bits.to(torch.float32) * 2.0 - 1.0


class Ising:
    """4 x 4 Ising interaction sparsification: the symmetric KL divergence
    between the original and the edge-masked model plus lamda times the
    edges kept (experiments/_ising.py:165-200). Every log partition
    function of a batch comes from one (2^16, batch) energy matrix: the
    adjacent-pair spin products times the masked interactions, then a
    logsumexp over the 65,536 configurations."""

    def __init__(self, lamda: float, seed: int = 0, device=None):
        device = resolve_device(device)
        self.lamda = lamda
        rng = np.random.default_rng(seed)
        h = ((rng.integers(0, 2, (ISING_GRID_H, ISING_GRID_W - 1)) * 2 - 1)
             * rng.uniform(0.05, 5.0, (ISING_GRID_H, ISING_GRID_W - 1)))
        v = ((rng.integers(0, 2, (ISING_GRID_H - 1, ISING_GRID_W)) * 2 - 1)
             * rng.uniform(0.05, 5.0, (ISING_GRID_H - 1, ISING_GRID_W)))
        self.h = torch.as_tensor(h.reshape(-1), dtype=torch.float32, device=device)
        self.v = torch.as_tensor(v.reshape(-1), dtype=torch.float32, device=device)
        self.h_ind = torch.as_tensor(_HORIZONTAL_IND, device=device)
        self.v_ind = torch.as_tensor(_VERTICAL_IND, device=device)

        spins = _all_spin_configs(ISING_GRID_H * ISING_GRID_W, device)
        g = spins.reshape(-1, ISING_GRID_H, ISING_GRID_W)
        # the adjacent-pair products of each configuration, (2^16, 12) each,
        # flattened in the (row, column) order of h and v
        self._pairs_h = (g[:, :, :-1] * g[:, :, 1:]).reshape(g.shape[0], -1)
        self._pairs_v = (g[:, :-1, :] * g[:, 1:, :]).reshape(g.shape[0], -1)
        energy = self._log_energy(self.h[None], self.v[None])[:, 0]
        m = torch.max(energy)
        density = torch.exp(energy - m)
        z = torch.sum(density)
        self.log_partition_original = torch.log(z) + m
        cov = (spins.T @ (spins * (density / z)[:, None])).reshape(
            ISING_GRID_H, ISING_GRID_W, ISING_GRID_H, ISING_GRID_W)
        # spin i sits at (row i // W, column i % W): the covariances of the
        # horizontal and the vertical neighbours, in the order of h and v
        r, c = np.divmod(np.arange(ISING_GRID_H * (ISING_GRID_W - 1)), ISING_GRID_W - 1)
        self._cov_h = cov[r, c, r, c + 1]
        r, c = np.divmod(np.arange((ISING_GRID_H - 1) * ISING_GRID_W), ISING_GRID_W)
        self._cov_v = cov[r, c, r + 1, c]

    def _log_energy(self, h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(2^16, batch) log energies for interactions h, v (batch, 12)."""
        return 2.0 * (self._pairs_h @ h.T) + 2.0 * (self._pairs_v @ v.T)

    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """x: (batch, 24) edge masks. The KL objective (lower is better)."""
        x = torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32))
        h_s = x[:, self.h_ind] * self.h[None]
        v_s = x[:, self.v_ind] * self.v[None]
        log_z_s = torch.logsumexp(self._log_energy(h_s, v_s), dim=0)
        kld_term = (self.h[None] - h_s) @ self._cov_h + (self.v[None] - v_s) @ self._cov_v
        kld = 2.0 * kld_term + log_z_s - self.log_partition_original
        return kld + self.lamda * torch.sum(x, dim=1)


def setup_ising(lamda: float = 1e-4, device=None):
    """24 binary edge masks (experiments/_ising.py:201-226)."""
    prior = BinaryPrior(ISING_N_EDGES, device=device)
    ising = Ising(lamda, device=device)

    def test_function(x: torch.Tensor) -> torch.Tensor:
        return -ising.evaluate(x)

    return prior, test_function
