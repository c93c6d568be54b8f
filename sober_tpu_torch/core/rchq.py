"""Kernel recombination (RCHQ), the quadrature core of SOBER (port of
sober_tpu/core/rchq.py).

Given N weighted candidates and s-1 Nystrom test functions, find <= s points
with non-negative weights whose weighted empirical measure matches the
candidate measure's mean embedding on the test-function span. The feature
strip Phi = U @ K(X_nys, X_cand) is formed once; a power-of-two slot tree
halves the pool round by round, each round one Caratheodory elimination
(`ops/car.py:car_eliminate`, a CUDA kernel on the card) on 2(n_test+1)
barycenters. The JAX package's static shapes are kept, so the same number
of eliminations runs per round; its lax.cond and top_k become a Python `if`
and a stable descending sort.

Invariants: w >= 0, sum w = sum mu, and Phi @ (w scattered) equals Phi @ mu
to fp32 tolerance (moment matching).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.car import car_eliminate
from ..utils import timing
from ..utils.linalg import symmetrize


class RecombinationResult(NamedTuple):
    idx: torch.Tensor   # (num_pts,) int64 indices into pts_rec
    w: torch.Tensor     # (num_pts,) non-negative weights (trailing may be 0)


def _top(x: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties broken by lower index like
    jax.lax.top_k (torch.topk leaves the order of ties unspecified, and zero
    weights tie all the time)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def nystrom_basis(k_nys: torch.Tensor, n_test: int) -> torch.Tensor:
    """Top-n_test spectral test functions (n_test, n_nys) of the PSD Gram.

    Small Grams (n_nys < 384, or n_test >= n_nys - 40) get the exact eigh;
    larger ones randomized subspace iteration with Rayleigh-Ritz (three power
    passes capture >= 99% of the exact top-n_test Rayleigh energy on the
    bench Grams). The probe is drawn from a generator on the Gram's device,
    seeded with the bit pattern of the float32 sum of the Gram, so the basis
    is deterministic for a given Gram while no fixed probe exists for an
    adversarial Gram to be orthogonal to."""
    n_nys = k_nys.shape[0]
    if n_nys < 384 or n_test >= n_nys - 40:
        _, eigvecs = torch.linalg.eigh(k_nys)              # ascending
        return eigvecs[:, -n_test:].T
    n_sub = min(n_test + 32, n_nys)
    total = torch.nan_to_num(torch.sum(k_nys)).to(torch.float32)
    timing.count("host_reads.nystrom_basis")
    seed = int(total.reshape(1).view(torch.int32)) & 0xFFFFFFFF
    gen = torch.Generator(device=k_nys.device).manual_seed(seed)
    omega = torch.randn((n_nys, n_sub), generator=gen, dtype=k_nys.dtype,
                        device=k_nys.device)
    q, _ = torch.linalg.qr(k_nys @ omega)
    for _ in range(3):
        q, _ = torch.linalg.qr(k_nys @ q)
    b = symmetrize(q.T @ (k_nys @ q))
    _, v = torch.linalg.eigh(b)                            # ascending
    return (q @ v[:, -n_test:]).T


# ----------------------------------------------------------------------------
# Caratheodory elimination
# ----------------------------------------------------------------------------

def null_basis(x: torch.Tensor, mu: torch.Tensor, n_elim: int,
               row_mask: torch.Tensor):
    """Null directions for eliminating from (x, mu); returns
    (big_n (m, n_take), n_take, active0).

    Directions must satisfy (a) x_active^T phi = 0 and (b) phi_i = 0 off the
    active set. Two cheap stages instead of an SVD of the indicator-augmented
    constraints: the complete-QR complement of the active rows satisfies (a);
    a small eigh of its inactive-row Gram splits off the directions that
    vanish on inactive rows (eigenvalue = squared inactive amplitude, kept
    when <= 1e-6, an absolute cutoff above the ~1e-7 fp32 noise floor); the
    others are zeroed, and the elimination skips zero directions."""
    m, p = x.shape
    active0 = ((mu > 0) & (row_mask > 0)).to(x.dtype)
    q_full, _ = torch.linalg.qr(x * active0[:, None], mode="complete")
    n0 = q_full[:, p:]                                     # (m, m - p)
    inact = 1.0 - active0
    n_take = min(n_elim, m - p)
    # in the halving tree the all-active case is the common one; there the
    # eigh would diagonalize an exactly-zero Gram, and any complement
    # columns are valid
    timing.count("host_reads.null_basis")
    if bool(torch.any(inact > 0.5)):
        d_gram = (n0 * inact[:, None]).T @ n0
        lam, c_vecs = torch.linalg.eigh(0.5 * (d_gram + d_gram.T))
        big_n = (n0 @ c_vecs[:, :n_take]) * (lam[:n_take] <= 1e-6).to(x.dtype)
    else:
        big_n = n0[:, :n_take]
    return big_n.contiguous(), n_take, active0


def _caratheodory(x: torch.Tensor, mu: torch.Tensor, n_elim: int,
                  row_mask: torch.Tensor) -> torch.Tensor:
    """Eliminate up to `n_elim` points from the weighted configuration
    (x (m, p) rows including the mass column, mu (m,)); padding rows
    (row_mask 0) never receive mass. Preserves x.T @ mu."""
    big_n, n_take, active0 = null_basis(x, mu, n_elim, row_mask)
    mu, elim = car_eliminate(mu.contiguous(), big_n, row_mask.contiguous(),
                             n_take)
    # rows outside the initial measure can only hold fp32 deflation dust
    return mu * (1.0 - elim) * active0


def _null_space_push(feats: torch.Tensor, mass: torch.Tensor,
                     obj: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Zero one more weight by pushing along the most-null direction of the
    kept configuration, in the direction that increases the objective
    (reference: SOBER/_rchq.py:87-105,177-196; obj = -calc_obj)."""
    xp = torch.cat([feats, mass[None, :]], dim=0).T        # (K, p)
    p = xp.shape[1]
    q_full, _ = torch.linalg.qr(xp, mode="complete")
    n0 = q_full[:, p:]
    inact = 1.0 - mass
    d_gram = (n0 * inact[:, None]).T @ n0
    lam, c_vecs = torch.linalg.eigh(0.5 * (d_gram + d_gram.T))
    w_null = n0 @ c_vecs[:, 0]
    timing.count("host_reads._null_space_push")
    if float(obj @ w_null) < 0:
        w_null = -w_null
    plis = w_null > 0
    alpha = torch.where(plis, w / torch.where(plis, w_null, 1.0), float("inf"))
    timing.count("host_reads._null_space_push", 2)
    idx = int(torch.argmin(alpha))
    if not bool(plis.any()):
        return w
    timing.count("host_reads._null_space_push")
    if not math.isfinite(float(alpha[idx])):
        return w
    timing.count("host_reads._null_space_push")
    if not float(lam[0]) <= 1e-6:
        return w
    w_new = torch.clamp_min(w - alpha[idx] * w_null, 0.0)
    w_new[idx] = 0.0
    return w_new


# ----------------------------------------------------------------------------
# hierarchical reduction over the precomputed feature matrix
# ----------------------------------------------------------------------------

def _reduce_tree(phi_ext: torch.Tensor, obj_ext: Optional[torch.Tensor],
                 mu_ext: torch.Tensor, n_test: int, n_pool: int):
    """Run the halving tree.

    phi_ext (n_test, n_pool+1) features with an all-zero dummy column last;
    obj_ext optional (n_pool+1,) negated objective, dummy 0; mu_ext
    (n_pool+1,) weights, dummy 0. Returns (idx (n_test+1,), w (n_test+1,)):
    the surviving pool indices with normalized weights, descending,
    zero-weight slots last and given distinct unused pool indices. Each
    halving round is a recombination.round span, the rest
    recombination.final."""
    use_obj = obj_ext is not None
    dev = phi_ext.device
    n_keep = n_test + 1                    # columns kept per round
    m = 2 * n_keep                         # barycenters per round
    n_rounds = max(0, math.ceil(math.log2(max(n_pool / m, 1.0))))
    e = 2 ** n_rounds
    dummy = n_pool
    slots = torch.cat([torch.arange(n_pool, device=dev),
                       torch.full((e * m - n_pool,), dummy, device=dev)])

    def run_car(bary_feats, bary_obj, mask, tot):
        """CAR (+ optional push) on m barycenters; at most n_keep of the
        returned weights are positive."""
        rows = [bary_feats] + ([bary_obj[None, :]] if use_obj else [])
        x_car = torch.cat(rows + [mask[None, :]], dim=0).T  # (m, p)
        mu_out = _caratheodory(x_car, tot, m - x_car.shape[1], mask)
        if use_obj:
            support = (mu_out > 0).to(x_car.dtype)
            mu_out = _null_space_push(bary_feats, support, bary_obj, mu_out)
        return mu_out

    for _ in range(n_rounds):
        with timing.span("recombination.round"):
            cols = slots.reshape(e, m)                         # member x bary
            w_cols = mu_ext[cols]                              # (e, m)
            tot = torch.sum(w_cols, dim=0)                     # (m,)
            safe_tot = torch.clamp_min(tot, 1e-30)
            bary = torch.einsum("tem,em->tm", phi_ext[:, cols], w_cols) / safe_tot
            mask = (tot > 0).to(phi_ext.dtype)
            bary_obj = (torch.einsum("em,em->m", obj_ext[cols], w_cols) / safe_tot
                        if use_obj else None)
            mu_out = run_car(bary, bary_obj, mask, tot)

            w_kept, kept = _top(mu_out, n_keep)
            tot_kept = tot[kept]
            scale = torch.where(tot_kept > 0,
                                w_kept / torch.clamp_min(tot_kept, 1e-30), 0.0)
            kept_cols = cols[:, kept]                          # (e, n_keep)
            new_w = w_cols[:, kept] * scale[None, :]
            # only the dummy index repeats, and it is zeroed right after
            mu_ext = torch.zeros_like(mu_ext).index_add_(
                0, kept_cols.reshape(-1), new_w.reshape(-1))
            mu_ext[dummy] = 0.0
            # fp drift control: renormalize to the original mass (= 1)
            total = torch.sum(mu_ext)
            mu_ext = torch.where(total > 0,
                                 mu_ext / torch.where(total > 0, total, 1.0), mu_ext)
            slots = kept_cols.reshape(-1)                      # (e * n_keep,)
        e //= 2

    with timing.span("recombination.final"):
        # final stage: <= m slots, CAR on raw points
        n_slots = slots.shape[0]
        if n_slots < m:
            slots = torch.cat([slots, torch.full((m - n_slots,), dummy, device=dev)])
        w_slots = mu_ext[slots]
        mask = (w_slots > 0).to(phi_ext.dtype)
        bary_obj = obj_ext[slots] if use_obj else None
        mu_out = run_car(phi_ext[:, slots], bary_obj, mask, w_slots)

        # every pool index occupies at most one slot, so the survivors are the
        # answer; only dummy slots repeat, and they carry zero weight
        _, order = _top(mu_out, m)                             # full descending
        slots_ord = slots[order]
        idx_kept = slots_ord[:n_keep]
        is_dummy = idx_kept == dummy
        w_kept = torch.where(is_dummy, 0.0, mu_out[order[:n_keep]])
        total = torch.sum(w_kept)
        w_kept = torch.where(total > 0, w_kept / torch.where(total > 0, total, 1.0),
                             w_kept)
        # dummy survivors (fewer than n_keep support points needed) get DISTINCT
        # pool indices from the non-kept non-dummy slots, or, if even those run
        # out, the highest-weight index, all with weight 0
        repl = slots_ord[n_keep:]                              # (m - n_keep,)
        repl_valid = repl != dummy
        n_repl = m - n_keep
        pos = torch.where(repl_valid, torch.cumsum(repl_valid, 0) - 1, n_repl)
        compact = torch.zeros(n_repl + 1, dtype=slots.dtype, device=dev)
        compact = compact.scatter(0, pos, repl)[:n_repl]
        n_valid = torch.sum(repl_valid)
        rank = torch.cumsum(is_dummy, 0) - 1
        last_resort = torch.where(idx_kept[0] == dummy, 0, idx_kept[0])
        fallback = torch.where(rank < n_valid,
                               compact[torch.clamp(rank, 0, n_repl - 1)],
                               last_resort)
        idx_kept = torch.where(is_dummy, fallback, idx_kept)
        return idx_kept, w_kept


def local_reduce(phi: torch.Tensor, mu: torch.Tensor, num_pts: int,
                 obj: Optional[torch.Tensor] = None) -> RecombinationResult:
    """Reduce one (n_test, blk) feature strip with unnormalized weights mu
    to <= num_pts support points, preserving sum(mu) and the strip's
    moments. `obj` is an optional (blk,) already-negated objective row."""
    n_rows, blk = phi.shape
    if num_pts != n_rows + 1:
        raise ValueError("num_pts must equal n_test + 1")
    mass = torch.sum(mu)
    mu_n = torch.where(mass > 0, mu / torch.where(mass > 0, mass, 1.0), mu)
    phi_ext = torch.cat([phi, phi.new_zeros((n_rows, 1))], dim=1)
    mu_ext = torch.cat([mu_n, mu.new_zeros((1,))])
    obj_ext = None if obj is None else torch.cat([obj, obj.new_zeros((1,))])
    idx, w = _reduce_tree(phi_ext, obj_ext, mu_ext, n_rows, blk)
    return RecombinationResult(idx, w * mass)


# ----------------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------------

def recombination(pts_rec: torch.Tensor, pts_nys: torch.Tensor, num_pts: int,
                  kernel: Callable, init_weights: Optional[torch.Tensor] = None,
                  calc_obj: Optional[Callable] = None,
                  extra_test_rows: Optional[torch.Tensor] = None,
                  mesh=None) -> RecombinationResult:
    """Sparsify a weighted candidate pool to `num_pts` quadrature points.

    pts_rec (N, d) candidate pool; pts_nys (n_nys, d) Nystrom subset;
    kernel: callable (X, Y) -> PSD Gram; init_weights optional (N,)
    importance weights (default uniform); calc_obj optional callable
    X -> (N,) acquisition values to maximize under the quadrature
    constraints; extra_test_rows optional (k, N) function values matched
    exactly beside the Nystrom eigenfunctions (k eigenfunction slots are
    given up for them). mesh: an optional parallel.mesh.Mesh with a "cand"
    axis; the strip K(X_nys, pool) is then formed shard by shard, each on
    its device, and gathered on the mesh's first (parallel.mesh.sweep; a
    pool the mesh does not divide is formed whole there), the rest as
    without one. Returns RecombinationResult(idx (s,), w (s,)); trailing
    weights may be zero.
    """
    n_pool = pts_rec.shape[0]
    n_extra = 0 if extra_test_rows is None else extra_test_rows.shape[0]
    n_test = num_pts - 1 - n_extra
    if n_test < 1:
        raise ValueError("num_pts too small for the extra test rows")
    if pts_nys.shape[0] < num_pts:
        raise ValueError(
            f"n_nys={pts_nys.shape[0]} must be >= num_pts={num_pts}")
    if init_weights is not None and init_weights.shape[0] != n_pool:
        raise ValueError(
            f"init_weights has {init_weights.shape[0]} entries but pts_rec "
            f"has {n_pool} rows")

    # the recorder's recombination.basis: the eigenbasis, the strip, phi
    with timing.span("recombination.basis"):
        # Nystrom spectral basis; jitter would only shift eigenvalues, so
        # symmetrize + NaN-scrub suffices
        k_nys = symmetrize(torch.nan_to_num(kernel(pts_nys, pts_nys)))
        u = nystrom_basis(k_nys, n_test)                       # (n_test, n_nys)
        if mesh is None:
            k_strip = kernel(pts_nys, pts_rec)                 # (n_nys, N)
        else:
            from ..parallel.mesh import sweep

            k_strip = sweep(mesh, functools.partial(kernel, pts_nys), pts_rec, dim=1)
        phi = u @ k_strip                                      # (n_test, N)
        # one GLOBAL scale lifts a nearly degenerate kernel's rows next to the
        # O(1) mass column while keeping the eigenvalue-weighted priority
        phi = phi / torch.clamp_min(torch.max(torch.abs(phi)), 1e-30)
        if extra_test_rows is not None:
            extra = extra_test_rows.to(phi.dtype)
            extra_scale = torch.clamp_min(
                torch.max(torch.abs(extra), dim=1, keepdim=True).values, 1e-30)
            phi = torch.cat([phi, extra / extra_scale], dim=0)
        n_rows = phi.shape[0]                                  # num_pts - 1
        phi_ext = torch.cat([phi, phi.new_zeros((n_rows, 1))], dim=1)

        if init_weights is None:
            mu = torch.full((n_pool,), 1.0 / n_pool, dtype=phi.dtype,
                            device=phi.device)
        else:
            mu = torch.clamp_min(init_weights, 0.0)
            tot = torch.sum(mu)
            mu = torch.where(tot > 0, mu / torch.where(tot > 0, tot, 1.0),
                             torch.full_like(mu, 1.0 / n_pool))
        mu_ext = torch.cat([mu, mu.new_zeros((1,))])
        obj_ext = None
        if calc_obj is not None:
            obj = -calc_obj(pts_rec)
            obj_ext = torch.cat([obj, obj.new_zeros((1,))])
    idx, w = _reduce_tree(phi_ext, obj_ext, mu_ext, n_rows, n_pool)
    return RecombinationResult(idx, w)
