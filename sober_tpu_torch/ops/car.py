"""Caratheodory elimination loop.

`car_eliminate` is the port of `sober_tpu/ops/pallas_car.py:
car_eliminate_pallas`: the n_take sequential eliminations of
`core/rchq.py:_caratheodory` in one kernel launch. On a CUDA tensor it
launches the hand-written kernel of `csrc/car_eliminate.cu` or raises; on a
CPU tensor it runs `car_eliminate_reference`, the same loop in plain
PyTorch. The algorithm and the kernel's three variants are documented in
`csrc/car_eliminate.cu`; `car_plan` picks the variant from the shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import check, load_library

MAX_M = 4096   # csrc/car_eliminate.cu: LPT * MAX_THREADS
# csrc/car_eliminate.cu: MAX_WIDTH, MAX_CLUSTER, SMEM_LIMIT
MAX_WIDTH = 256
MAX_CLUSTER = 8
SMEM_LIMIT = 232_448 - 1_024
VARIANTS = ("smem", "cluster", "l2")


class CarPlan(NamedTuple):
    variant: str      # "smem": one block; "cluster": `cluster` blocks; "l2"
    cluster: int      # blocks per CAR
    smem_bytes: int   # dynamic shared memory per block


def _fit(m: int, q: int, cluster: int) -> CarPlan | None:
    """The shared-memory plan with `cluster` blocks, if they hold the basis:
    each block's slots of the warps' candidates (2 x cluster x warps x
    16 B, a warp per 8 lanes), the Householder vector in fp64 and fp32
    (12 qp B, qp = q rounded up to 8) and its width columns of qp + 4 fp32
    words."""
    width = -(-m // cluster)
    qp = -(-q // 8) * 8
    smem = 32 * cluster * -(-width // 8) + 12 * qp + 4 * width * (qp + 4)
    if width > MAX_WIDTH or smem > SMEM_LIMIT:
        return None
    return CarPlan("smem" if cluster == 1 else "cluster", cluster, smem)


def car_plan(m: int, q: int) -> CarPlan:
    """The kernel variant for an (m, q) basis, by shape alone.

    One block when the basis fits it: m <= 256 lanes, and q rows of its m
    columns, the Householder vector and the candidate slots in 227 KB. Else
    a cluster of 8 blocks (the largest portable cluster), each holding
    ceil(m / 8) lanes with all q rows: on an H100 at m=400, q=200 it beat
    clusters of 2 and 4 (PERF.md). A basis that no such cluster holds stays
    in L2 (the first port's kernel). m=200, q=100 takes one block
    (88,448 B); m=400, q=200 a cluster of 8 (44,992 B each); m=1000,
    q=500 the L2 kernel."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"car_eliminate: m={m} outside [1, {MAX_M}]")
    if q < 0:
        raise ValueError(f"car_eliminate: q={q} < 0")
    for c in (1, MAX_CLUSTER):
        plan = _fit(m, q, c)
        if plan is not None:
            return plan
    return CarPlan("l2", 1, 4 * max(q, 1))


def car_eliminate_reference(mu: torch.Tensor, big_n: torch.Tensor,
                            row_mask: torch.Tensor, n_take: int):
    """Plain PyTorch loop with the kernel's semantics.

    mu (m,) weights, big_n (m, q) null basis (column j = direction j; zero
    columns are no-ops), row_mask (m,), n_take <= q. Returns (mu', elim).
    Written in the kernel's transposed-row form: step t reflects rows >= t
    of the (q, m) basis and then leaves row t behind, which is algebraically
    the drop-first-column form of `sober_tpu/core/rchq.py:_caratheodory`.
    """
    out = (mu, torch.zeros_like(mu))
    for out in _reference_steps(mu, big_n, row_mask, n_take):
        pass
    return out


def _reference_steps(mu: torch.Tensor, big_n: torch.Tensor,
                     row_mask: torch.Tensor, n_take: int):
    """car_eliminate_reference's loop, yielding (mu, elim) after each step."""
    nt = big_n.T.clone()                                  # (q, m)
    elim = torch.zeros_like(mu)
    inf = torch.full_like(mu, float("inf"))
    for t in range(n_take):
        phi = nt[t]
        mu = mu * (1.0 - elim)
        active = (mu > 0) & (row_mask > 0) & (elim < 0.5)
        has_norm = torch.sum(phi * phi) > 1e-10
        pos = (phi > 0) & active
        phi = torch.where(pos.any(), phi, -phi)
        plis = (phi > 0) & active
        alpha = torch.where(plis, mu / torch.where(plis, phi, 1.0), inf)
        idx = torch.argmin(alpha).reshape(1)               # first minimum
        a_min = alpha[idx]
        valid = has_norm & plis.any() & torch.isfinite(a_min[0])
        mu_new = torch.clamp_min(mu - a_min * phi, 0.0).index_fill(0, idx, 0.0)
        mu = torch.where(valid, mu_new, mu)
        elim = torch.where(valid, elim.index_fill(0, idx, 1.0), elim)
        # Householder deflation of rows >= t
        u = nt[t:, idx][:, 0]
        unorm = torch.sqrt(torch.sum(u * u))
        v = u.clone()
        v[0] += torch.where(u[0] >= 0, unorm, -unorm)
        vsq = torch.clamp_min(torch.sum(v * v), 1e-30)
        w_row = v @ nt[t:]
        nt[t:] -= (valid * 2.0 / vsq) * torch.outer(v, w_row)
        yield mu, elim


def reference_horizon(mu: torch.Tensor, big_n: torch.Tensor,
                      row_mask: torch.Tensor, n_take: int,
                      tol: float = 1e-6) -> int:
    """How many steps the float32 reference can be held to exactly.

    The elimination is chaotic in fp32: each step's alpha divides by mu of
    a lane that earlier steps have whittled down, so rounding in mu grows
    from step to step, and after a few dozen steps two correct fp32
    implementations pick different lanes (equally valid results, with the
    same moments). This returns the largest step count k <= n_take such that
    the reference run in float32 and in float64 agree after every step up to
    k: the same eliminated lanes and |dmu| <= tol. Up to k, rounding does
    not yet decide the answer, so a kernel can be compared with the
    reference exactly. The two runs are walked in lockstep: once they part,
    they can meet again within tol after the lanes they differ on are
    eliminated (chip_smoke.py's car_problem(128, 64) does), so their
    agreement at one k says nothing of the steps before it."""
    k = 0
    for (m32, e32), (m64, e64) in zip(
            _reference_steps(mu, big_n, row_mask, n_take),
            _reference_steps(mu.double(), big_n.double(), row_mask.double(), n_take)):
        if not (torch.equal(e32.double(), e64)
                and float((m32.double() - m64).abs().max()) <= tol):
            break
        k += 1
    return k


def _check_operand(name: str, t: torch.Tensor, shape: tuple,
                   device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"car_eliminate: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"car_eliminate: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(
            f"car_eliminate: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"car_eliminate: {name} must be contiguous")


def car_eliminate(mu: torch.Tensor, big_n: torch.Tensor,
                  row_mask: torch.Tensor, n_take: int):
    """Run n_take eliminations; returns (mu', elim), float32 like mu.

    mu and row_mask are (m,) with big_n (m, q), or a batch of independent
    CARs, (b, m) with (b, m, q). CPU tensors take the reference; CUDA
    tensors launch the kernel variant that `car_plan` picks."""
    if mu.device.type == "cpu":
        if mu.dim() == 2:
            outs = [car_eliminate_reference(*a, n_take)
                    for a in zip(mu, big_n, row_mask)]
            return tuple(torch.stack(o) for o in zip(*outs))
        return car_eliminate_reference(mu, big_n, row_mask, n_take)
    if mu.device.type != "cuda":
        raise ValueError(f"car_eliminate: unsupported device {mu.device}")
    if big_n.dim() not in (2, 3) or mu.dim() != big_n.dim() - 1:
        raise ValueError(f"car_eliminate: big_n must be (m, q) or (b, m, q) "
                         f"beside mu (m,) or (b, m); got {tuple(big_n.shape)} "
                         f"and {tuple(mu.shape)}")
    m, q = big_n.shape[-2:]
    return _launch(mu, big_n, row_mask, n_take, car_plan(m, q))


def _launch(mu, big_n, row_mask, n_take: int, plan: CarPlan):
    """Launch `plan`'s variant. `car_eliminate` passes car_plan's choice;
    another plan is only for timing the alternatives (chip_smoke.py)."""
    m, q = big_n.shape[-2:]
    batch = big_n.shape[0] if big_n.dim() == 3 else 1
    lead = tuple(big_n.shape[:-2])
    if not 0 <= n_take <= q:
        raise ValueError(f"car_eliminate: n_take={n_take} outside [0, q={q}]")
    if batch < 1:
        raise ValueError("car_eliminate: empty batch")
    _check_operand("mu", mu, lead + (m,), mu.device)
    _check_operand("big_n", big_n, lead + (m, q), mu.device)
    _check_operand("row_mask", row_mask, lead + (m,), mu.device)
    scratch = (torch.empty((batch, q, m), dtype=torch.float32, device=mu.device)
               if plan.variant == "l2" else None)
    mu_out = torch.empty_like(mu)
    elim = torch.empty_like(mu)
    lib = load_library()
    # the C side launches on the current device: make the operands' current
    with torch.cuda.device(mu.device):
        rc = lib.sober_car_eliminate(
            mu.data_ptr(), big_n.data_ptr(), row_mask.data_ptr(),
            None if scratch is None else scratch.data_ptr(), mu_out.data_ptr(),
            elim.data_ptr(), batch, m, q, n_take,
            0 if plan.variant == "l2" else plan.cluster,
            torch.cuda.current_stream(mu.device).cuda_stream)
    check(rc, f"car_eliminate ({plan.variant}, cluster {plan.cluster})")
    car_eliminate.launches += 1
    car_eliminate.variant_launches[plan.variant] += 1
    return mu_out, elim


car_eliminate.launches = 0
# launches by variant, beside the total
car_eliminate.variant_launches = dict.fromkeys(VARIANTS, 0)
