"""Roofline arithmetic of the program's kernels, counted from the shapes at
their public entries (copied from chip_smoke.py:bound_ms, car_bounds and
the RBF and Tanimoto counts, so that changes to the program cannot move
the yardstick).

Each function gives the least time the work could take on one NVIDIA H100
SXM at its published dense peaks: the larger of the bytes over the HBM rate
and the operations over their peak rate. Each input byte is counted read
once and each output byte written once; work that depends on the data
counts what these inputs need.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense): HBM bytes/s; float32 and float64
# FLOP/s outside the tensor cores; int8 tensor-core OP/s
HBM_RATE, FP32_PEAK, FP64_PEAK, INT8_PEAK = 3.35e12, 67e12, 34e12, 1979e12


def bound_s(n_bytes: float, t_ops: float) -> float:
    """max(bytes at the HBM rate, the operations' own time), in seconds."""
    return max(n_bytes / HBM_RATE, t_ops)


def rbf_gram_s(n: int, m: int, d: int) -> float:
    """The (n, m) RBF Gram of float32 x (n, d) and y (m, d): x, y read and
    the Gram written once; 3 d + 2 float32 flops an entry (a difference and
    a square-add a feature; the exponential and the scale)."""
    return bound_s(4.0 * ((n + m) * d + n * m), n * m * (3.0 * d + 2.0) / FP32_PEAK)


def tanimoto_gram_s(n: int, m: int, d: int) -> float:
    """The (n, m) Tanimoto Gram of 0/1 fingerprints x (n, d) and y (m, d):
    each fingerprint read once as its d bits, the float32 Gram written once;
    2 d operations an entry (an AND and a population count a bit) at the
    int8 tensor-core rate."""
    return bound_s((n + m) * d / 8.0 + 4.0 * n * m, 2.0 * n * m * d / INT8_PEAK)


def car_s(m: int, q: int, n_elim: int) -> float:
    """One Caratheodory elimination run on m weights with a (m, q) null
    basis that eliminated n_elim lanes: the basis, weights and masks read
    and written once; in step t, 2 m (q - t) float64 flops of the dot
    product and as many float32 flops of the rank-1 update."""
    flops = 2.0 * m * sum(q - t for t in range(n_elim))
    return bound_s(4.0 * (m * q + 4 * m), flops / FP64_PEAK + flops / FP32_PEAK)
