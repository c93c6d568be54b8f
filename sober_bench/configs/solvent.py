"""The `solvent` configuration's data: QM9's dipole moments over its 133,303
molecules, each SMILES string as a 2048-bit hashed character 1-4-gram
fingerprint (a frozen copy of the port's fallback featurizer; RDKit's
Morgan fingerprints where RDKit exists, which it does not on the card's
machine). The CSV is read as a file. The fingerprints are cached, packed
into bits, in a fixed directory inside the checkout, so only a checkout's
first run computes them; the cache's name carries a hash of the CSV and of
this featurizer."""
from __future__ import annotations

import csv
import hashlib
import zlib
from pathlib import Path

import numpy as np
import torch

N_BITS = 2048
NGRAMS = (1, 4)
CACHE_DIR = Path(__file__).resolve().parents[1] / ".cache"
FEATURIZER = "crc32 char n-grams 1-4 mod 2048, v1"


def read_csv(path: Path):
    smiles, targets = [], []
    with open(path, encoding="utf-8-sig") as f:
        for row in csv.DictReader(f):
            smiles.append(row["smiles"])
            targets.append(float(row["dipole"]))
    return smiles, np.asarray(targets, np.float32)


def fingerprints(smiles) -> np.ndarray:
    """(n, 2048) uint8 0/1: bit crc32(g) mod 2048 set for every character
    n-gram g of length 1 to 4."""
    out = np.zeros((len(smiles), N_BITS), np.uint8)
    for i, s in enumerate(smiles):
        for n in range(NGRAMS[0], NGRAMS[1] + 1):
            for j in range(len(s) - n + 1):
                out[i, zlib.crc32(s[j:j + n].encode()) % N_BITS] = 1
    return out


def _cached(path: Path, n_pool):
    raw = path.read_bytes()
    key = hashlib.sha256(raw + FEATURIZER.encode() + str(n_pool).encode()).hexdigest()[:16]
    cache = CACHE_DIR / f"solvent_{key}.npz"
    if cache.exists():
        with np.load(cache) as z:
            return z["bits"], z["targets"]
    smiles, targets = read_csv(path)
    if n_pool is not None:
        smiles, targets = smiles[:n_pool], targets[:n_pool]
    bits = np.packbits(fingerprints(smiles), axis=1)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_suffix(".tmp.npz")
    np.savez(tmp, bits=bits, targets=targets)
    tmp.replace(cache)
    return bits, targets


def load(config: dict, device, n_pool=None):
    """(features (n, 2048) float32 0/1, targets (n,) float32) on `device`;
    n_pool keeps the first n_pool molecules (tests)."""
    root = Path(__file__).resolve().parents[2]
    bits, targets = _cached(root / config["data"]["csv"], n_pool)
    packed = torch.as_tensor(bits, device=device)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    feats = ((packed[:, :, None] >> shifts) & 1).reshape(packed.shape[0], -1)
    return (feats[:, :N_BITS].to(torch.float32).contiguous(),
            torch.as_tensor(targets, device=device))
