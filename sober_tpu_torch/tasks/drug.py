"""Dataset-as-domain drug-discovery tasks: malaria and solvent (port of
sober_tpu/tasks/drug.py; experiments/_generate_drug_dataset.py).

SMILES strings become 2048-bit fingerprints: RDKit's Morgan fingerprints
when RDKit is importable, else a hashed character-n-gram fingerprint of the
string (a sparse, similarity-preserving 2048-bit code, as in the JAX
package). The CSVs are the JAX package's own, read from
`sober_tpu/tasks/data/` without importing that package.
"""
from __future__ import annotations

import csv
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..priors.dataset import DatasetPrior

DATA_DIR = Path(__file__).resolve().parents[2] / "sober_tpu" / "tasks" / "data"
N_BITS = 2048
BOND_RADIUS = 3


def _morgan_fingerprints(smiles_list) -> Optional[np.ndarray]:
    try:
        from rdkit.Chem import AllChem, MolFromSmiles
    except ImportError:
        return None
    fps = [np.asarray(AllChem.GetMorganFingerprintAsBitVect(
        MolFromSmiles(s), BOND_RADIUS, nBits=N_BITS)) for s in smiles_list]
    return np.asarray(fps, np.float32)


def _ngram_fingerprints(smiles_list, n_lo: int = 1,
                        n_hi: int = 4) -> np.ndarray:
    """Hashed character-n-gram fingerprint (2048 bits)."""
    out = np.zeros((len(smiles_list), N_BITS), np.float32)
    for i, s in enumerate(smiles_list):
        for n in range(n_lo, n_hi + 1):
            for j in range(len(s) - n + 1):
                out[i, zlib.crc32(s[j:j + n].encode()) % N_BITS] = 1.0
    return out


def fingerprint_route() -> str:
    """Which fingerprints featurise_smiles makes here: "rdkit" (Morgan) when
    RDKit is importable, else "ngram"."""
    try:
        import rdkit.Chem.AllChem  # noqa: F401
    except ImportError:
        return "ngram"
    return "rdkit"


def featurise_smiles(smiles_list) -> np.ndarray:
    fps = _morgan_fingerprints(smiles_list)
    return _ngram_fingerprints(smiles_list) if fps is None else fps


def _read_csv(path, smiles_col: str, target_col: str):
    smiles, targets = [], []
    with open(path, encoding="utf-8-sig") as f:
        for row in csv.DictReader(f):
            smiles.append(row[smiles_col])
            targets.append(float(row[target_col]))
    return smiles, np.asarray(targets, np.float32)


def create_malaria_dataset(data_path: Optional[str] = None):
    """2048-bit fingerprints and negated EC50 activities, as CPU tensors
    (experiments/_generate_drug_dataset.py:7-33)."""
    smiles, targets = _read_csv(data_path or DATA_DIR / "malaria_box_dataset.csv",
                                "Canonical_Smiles", "Activity (EC50 uM)")
    return (torch.from_numpy(featurise_smiles(smiles)),
            torch.from_numpy(-targets))                  # maximize


def create_solvent_dataset(data_path: Optional[str] = None):
    """2048-bit fingerprints and dipole moments, as CPU tensors
    (experiments/_generate_drug_dataset.py:35-60)."""
    smiles, targets = _read_csv(data_path or DATA_DIR / "QM9_dipole.csv",
                                "smiles", "dipole")
    return torch.from_numpy(featurise_smiles(smiles)), torch.from_numpy(targets)


def _subsample(features, targets, n_pool, seed):
    """A uniform subsample of n_pool rows (all rows when n_pool is None),
    drawn with numpy as the JAX package does, so both take the same rows."""
    if n_pool is None or n_pool >= features.shape[0]:
        return features, targets
    idx = np.random.default_rng(seed).choice(
        features.shape[0], n_pool, replace=False)
    idx = torch.from_numpy(np.sort(idx))
    return features[idx], targets[idx]


def setup_malaria(data_path: Optional[str] = None, n_pool: int = None,
                  seed: int = 0, device=None) -> DatasetPrior:
    """(experiments/_malaria.py:18-27); the prior lives on `device`, CUDA
    unless given."""
    features, targets = _subsample(*create_malaria_dataset(data_path),
                                   n_pool, seed)
    return DatasetPrior(features, targets, device=device)


def setup_solvent(data_path: Optional[str] = None, n_pool: int = None,
                  seed: int = 0, device=None) -> DatasetPrior:
    """(experiments/_solvent.py:18-27); the prior lives on `device`, CUDA
    unless given."""
    features, targets = _subsample(*create_solvent_dataset(data_path),
                                   n_pool, seed)
    return DatasetPrior(features, targets, device=device)
