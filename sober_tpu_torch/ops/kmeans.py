"""Lloyd's KMeans with a fixed iteration count (port of
sober_tpu/ops/kmeans.py; the Nystrom sparsifier of SOBER/_weights.py:95-125).

The E-step uses the norm-trick distance ||x||^2 - 2 x.c + ||c||^2, the JAX
package's formula (torch.cdist switches formulas with the size, and the
labels would differ). The M-step sums each cluster's points as one matmul
with the one-hot labels, where the JAX package takes segment sums: on the
card index_add_ adds with atomics in no fixed order, so its centroids, and
every batch chosen downstream, would differ in the last bits from run to
run. The loop has no host read.
"""
from __future__ import annotations

import torch


def _assign(x: torch.Tensor, x2: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d2 = x2 - 2.0 * (x @ c.T) + torch.sum(c * c, dim=1)[None, :]
    return torch.argmin(d2, dim=1)         # ties to the lower index, as JAX


def kmeans(x: torch.Tensor, n_clusters: int, n_iter: int = 10):
    """Returns (labels, centroids). The centroids start at the first K
    points (SOBER/_weights.py:103); an empty cluster keeps its previous
    centroid."""
    c = x[:n_clusters].clone()
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    clusters = torch.arange(n_clusters, device=x.device)
    for _ in range(n_iter):
        one_hot = (_assign(x, x2, c)[:, None] == clusters[None, :]).to(x.dtype)
        counts = torch.sum(one_hot, dim=0)
        new_c = (one_hot.T @ x) / torch.clamp_min(counts, 1.0)[:, None]
        c = torch.where(counts[:, None] > 0, new_c, c)
    return _assign(x, x2, c), c


def kmeans_resampling(x: torch.Tensor, n_clusters: int,
                      n_iter: int = 10) -> torch.Tensor:
    """A point cloud sparsified to its centroids (SOBER/_weights.py:95-97)."""
    return kmeans(x, n_clusters, n_iter)[1]
