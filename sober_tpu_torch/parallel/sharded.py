"""Explicitly sharded compute paths (port of sober_tpu/parallel/sharded.py).

The candidate-axis math written as per-shard blocks and cross-shard
reductions, the twin of the JAX package's shard_map programs: pi
evaluation is embarrassingly parallel; the Nystrom feature matmul is a
block-row matmul; a barycenter reduction is a per-shard partial sum and one
sum across shards; recombination reduces each shard's block to <= num_pts
survivors and merges the survivors. The FBGP hypersample axis ("hyper")
shards the chains and their Cholesky caches.

Each entry point first enqueues every shard's work on its own device, then
reduces: a partial goes to the mesh axis's first device, is reduced there
and comes back (parallel/mesh.py:reduce_to_shards), as device tensors. The
port's recombination tree (core/rchq.py) reads the host in its rounds, as
it does without a mesh. JAX's program cache (_PROGRAM_CACHE and its
id(fbgp) key) serves its jit cache and has no counterpart: the port runs
eagerly.

A pool, weights or extra rows may be passed whole (they are cut into the
mesh's blocks and moved) or as a `Sharded`; the mesh must divide their
length, as shard_map requires. Results that JAX leaves sharded come back as
a `Sharded`; replicated ones on the axis's first device. An axis of one
shard is the single-device path (recombination has nothing to merge), so
each entry point then equals its unsharded counterpart.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..config import settings
from ..core.pi import lfi
from ..core.rchq import (RecombinationResult, local_reduce, nystrom_basis,
                         recombination)
from ..gp.exact import GPState, predictive_covariance
from ..utils.linalg import symmetrize
from .mesh import Mesh, Sharded, blocks_of, reduce_to_shards, to_device


def _per_shard(obj, devs: list) -> list:
    """obj on each shard's device, one copy a distinct device."""
    copies = {d: to_device(obj, d) for d in set(devs)}
    return [copies[d] for d in devs]


def _pi_weight_blocks(devs, states, etas, x_blks, pdf_blks, eps, n_total):
    """Per-shard pi-importance weights with a global normalization
    (utils/weights.py:cleansing_weights on a sharded axis): every shard's
    weights are formed before the one cross-shard sum."""
    ws = []
    for state, eta, xb, pb in zip(states, etas, x_blks, pdf_blks):
        w = lfi(state, eta, xb) / torch.clamp_min(pb, 1e-38)
        w = torch.where(w < eps, 0.0, w)
        ws.append(torch.where(torch.isfinite(w), w, eps))
    totals = reduce_to_shards([torch.sum(w) for w in ws], devs)
    return [torch.where(t > 0, w / torch.where(t > 0, t, 1.0),
                        torch.full_like(w, 1.0 / n_total))
            for w, t in zip(ws, totals)]


def _merge_survivors(devs, phi_blks, w_blks, num_pts, extra_blks=None,
                     obj_blks=None) -> RecombinationResult:
    """Each shard's block reduced to <= num_pts survivors, then one merge.

    phi is scaled by the GLOBAL max |phi| (one cross-shard max) before any
    shard's tree runs, as core/rchq.py scales the whole strip; `extra_blks`
    (pinned-integrand rows) by their per-row global maxima, appended below.
    `obj_blks` is each shard's already-negated objective row; it rides the
    local trees and the merge. Indices come back global: idx_loc + shard *
    blk."""
    gmax = reduce_to_shards([torch.amax(torch.abs(p)) for p in phi_blks], devs,
                            torch.amax)
    phi_blks = [p / torch.clamp_min(g, 1e-30) for p, g in zip(phi_blks, gmax)]
    if extra_blks is not None:
        escale = reduce_to_shards(
            [torch.amax(torch.abs(e), dim=1, keepdim=True) for e in extra_blks],
            devs, torch.amax)
        phi_blks = [torch.cat([p, e.to(p.dtype) / torch.clamp_min(s, 1e-30)])
                    for p, e, s in zip(phi_blks, extra_blks, escale)]
    blk = phi_blks[0].shape[1]
    idx, w, phi, obj = [], [], [], []
    for k, (p, wb) in enumerate(zip(phi_blks, w_blks)):
        ob = None if obj_blks is None else obj_blks[k]
        i_loc, w_loc = local_reduce(p, wb, num_pts, obj=ob)
        idx.append(i_loc + k * blk)
        w.append(w_loc)
        phi.append(p[:, i_loc])
        if ob is not None:
            obj.append(ob[i_loc])
    d0 = devs[0]
    gather = lambda ts, dim=0: torch.cat([t.to(d0) for t in ts], dim=dim)
    idx_surv = gather(idx)
    i_fin, w_fin = local_reduce(gather(phi, 1), gather(w), num_pts,
                                obj=gather(obj) if obj else None)
    return RecombinationResult(idx_surv[i_fin], w_fin)


def sharded_pi_weights(mesh: Mesh, state: GPState, eta: torch.Tensor,
                       x_cand, prior_pdf, axis: str = "cand") -> Sharded:
    """pi-importance weights with the candidate axis sharded over `axis`:
    each shard computes pi on its block; the normalization is one sum
    across shards. Returns the weights as a Sharded."""
    devs = mesh.axis_devices(axis)
    x_blks = blocks_of(mesh, x_cand, axis)
    ws = _pi_weight_blocks(devs, _per_shard(state, devs), _per_shard(eta, devs),
                           x_blks, blocks_of(mesh, prior_pdf, axis),
                           settings().eps_weights, sum(b.shape[0] for b in x_blks))
    return Sharded(ws, mesh, axis, 0)


def sharded_nystrom_features(mesh: Mesh, state: GPState, u: torch.Tensor,
                             x_nys: torch.Tensor, x_cand,
                             axis: str = "cand") -> Sharded:
    """Phi = U @ k_post(X_nys, X_cand) with the candidate axis sharded: each
    shard forms its (n_test, blk) strip; the result stays sharded along its
    second axis."""
    devs = mesh.axis_devices(axis)
    blks = [u_k @ predictive_covariance(s_k, n_k, xb) for s_k, u_k, n_k, xb in zip(
        _per_shard(state, devs), _per_shard(u, devs), _per_shard(x_nys, devs),
        blocks_of(mesh, x_cand, axis))]
    return Sharded(blks, mesh, axis, 1)


def sharded_barycenter_sums(mesh: Mesh, phi_sharded, weights, group_ids,
                            n_groups: int, axis: str = "cand") -> torch.Tensor:
    """Per-group weighted feature sums (n_groups, n_test) across a sharded
    candidate axis: a segment sum per shard, as a one-hot matmul (no
    atomics, so the sum is reproducible on the card), then one sum across
    shards, on the axis's first device."""
    devs = mesh.axis_devices(axis)
    parts = []
    for p, w, g in zip(blocks_of(mesh, phi_sharded, axis, dim=1),
                       blocks_of(mesh, weights, axis), blocks_of(mesh, group_ids, axis)):
        onehot = (g[:, None] == torch.arange(n_groups, device=g.device)).to(p.dtype)
        parts.append(onehot.T @ (p * w[None, :]).T)
    return torch.sum(torch.stack([q.to(devs[0]) for q in parts]), dim=0)


def _check_sizes(n_nys: int, num_pts: int, n_extra: int) -> int:
    if n_nys < num_pts:
        raise ValueError(f"n_nys={n_nys} must be >= num_pts={num_pts}")
    if num_pts - 1 - n_extra < 1:
        raise ValueError("num_pts too small for the extra test rows")
    return num_pts - 1 - n_extra


def sharded_recombination(mesh: Mesh, kernel: Callable, x_cand,
                          x_nys: torch.Tensor, weights, num_pts: int,
                          axis: str = "cand", calc_obj: Optional[Callable] = None,
                          extra_test_rows=None) -> RecombinationResult:
    """Kernel recombination with the candidate axis sharded: the
    (n_test, n_rec) feature strip never exists whole on one device.

    Recombination distributes over a partition of the measure: reducing each
    shard to <= num_pts support points keeps that shard's mass and feature
    moments, so the merge of the survivors keeps the global measure's.
    Per shard: its strip of Phi = U k(X_nys, X_cand), scaled by the global
    max |Phi| (one cross-shard max), the full halving tree
    (core/rchq.py:local_reduce); then one reduction over the
    n_shards * num_pts survivors picks the batch.

    `kernel`: (X, Y) -> Gram, moved to each shard's device
    (mesh.to_device); `weights` should be cleansed globally (e.g.
    sharded_pi_weights). `calc_obj` (X -> (n,) values to maximize) adds
    its negated row to every shard's tree and to the merge;
    `extra_test_rows` ((k, n_rec), sharded like the pool) are matched
    exactly beside the eigenfunctions (k eigenfunction slots are given up).
    Returns (idx (num_pts,), w (num_pts,)), global indices into x_cand, on
    the axis's first device."""
    n_extra = 0 if extra_test_rows is None else extra_test_rows.shape[0]
    n_test = _check_sizes(x_nys.shape[0], num_pts, n_extra)
    devs = mesh.axis_devices(axis)
    x_nys = x_nys.to(devs[0])
    x_blks = blocks_of(mesh, x_cand, axis)
    w_blks = blocks_of(mesh, weights, axis)
    extra_blks = (None if extra_test_rows is None
                  else blocks_of(mesh, extra_test_rows, axis, dim=1))
    if len(devs) == 1:
        # one shard: the single-device path, with nothing to merge
        return recombination(x_blks[0], x_nys, num_pts, kernel, init_weights=w_blks[0],
                             calc_obj=calc_obj,
                             extra_test_rows=None if extra_blks is None else extra_blks[0])
    # symmetrize and scrub only: jitter would shift eigenvalues, not vectors
    k_nys = symmetrize(torch.nan_to_num(kernel(x_nys, x_nys)))
    u = nystrom_basis(k_nys, n_test)
    phi_blks = [u_k @ k_k(n_k, xb) for u_k, k_k, n_k, xb in zip(
        _per_shard(u, devs), _per_shard(kernel, devs), _per_shard(x_nys, devs), x_blks)]
    obj_blks = (None if calc_obj is None else
                [-o_k(xb) for o_k, xb in zip(_per_shard(calc_obj, devs), x_blks)])
    return _merge_survivors(devs, phi_blks, w_blks, num_pts,
                            extra_blks=extra_blks, obj_blks=obj_blks)


def sharded_acquisition(mesh: Mesh, state: GPState, eta: torch.Tensor, x_cand,
                        x_nys: torch.Tensor, prior_pdf, num_pts: int,
                        axis: str = "cand", calc_obj: Optional[Callable] = None):
    """The SOBER acquisition (pi weighting + kernel recombination) over the
    sharded candidate axis, the mesh form of core/fused.py:fused_acquisition:
    sharded_pi_weights, then sharded_recombination over the posterior
    covariance, on the same blocks. `calc_obj` (X -> values to maximize)
    augments the trees and the merge with its negated row.

    Returns (idx, w, weights): global batch indices and quadrature weights
    on the axis's first device, and the cleansed pool weights as a
    Sharded."""
    x_cand = Sharded(blocks_of(mesh, x_cand, axis), mesh, axis, 0)
    weights = sharded_pi_weights(mesh, state, eta, x_cand, prior_pdf, axis)
    idx, w = sharded_recombination(mesh, functools.partial(predictive_covariance, state),
                                   x_cand, x_nys, weights, num_pts, axis, calc_obj=calc_obj)
    return idx, w, weights


def sharded_fbgp_batch_predict(mesh: Mesh, fbgp, x_test: torch.Tensor,
                               axis: str = "hyper"):
    """The FBGP's marginal prediction with its chains sharded over `axis`:
    each shard owns a block of chains and of their caches (L^-1, alpha) and
    predicts with them (FullyBayesianGP.fitbo_predict); the
    hyperposterior-weighted mean and second moment are summed across
    shards. The mesh must divide the chain count. Returns (mu, var) on the
    axis's first device."""
    devs = mesh.axis_devices(axis)
    parts = []
    for d, theta, linv, alpha, w in zip(
            devs, blocks_of(mesh, fbgp.Theta_qd, axis), blocks_of(mesh, fbgp._cache.linv, axis),
            blocks_of(mesh, fbgp._cache.alpha, axis), blocks_of(mesh, fbgp.w_qd, axis)):
        # a chain's prediction reads the observed inputs and mask only
        local = type(fbgp).from_arrays(fbgp.Xobs.to(d), None, to_device(fbgp.mask, d),
                                       None, None, None, None)
        mu_b, var_b = local.fitbo_predict(x_test.to(d), theta, linv, alpha)
        parts.append((w @ mu_b, w @ (var_b + mu_b ** 2)))
    mu = torch.sum(torch.stack([p[0].to(devs[0]) for p in parts]), dim=0)
    e2 = torch.sum(torch.stack([p[1].to(devs[0]) for p in parts]), dim=0)
    return mu, e2 - mu ** 2
