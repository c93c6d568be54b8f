"""Tanimoto similarity of 0/1 fingerprints: `|x & y| / (|x| + |y| - |x & y|)`.

`tanimoto_similarity` is the port of
`sober_tpu/ops/pallas_kernels.py:tanimoto_gram_pallas`. On a CUDA tensor it
packs both operands into 32-bit words (`pack_bits`) and launches the
popcount Gram of `csrc/tanimoto_gram.cu`, or raises; on a CPU tensor it
computes `tanimoto_similarity_reference`, the plain PyTorch version (the
one-matmul form of `sober_tpu/ops/kernels.py:tanimoto_gram`, exact for 0/1
operands in fp32 with TF32 off).

Packed layout (the kernel's, emulated by `pack_bits_reference`): row i
becomes ceil(d/32) words; bit l of word w holds element 32w + l, and
elements past d are zero bits. Words are stored as int32 bit patterns.
"""
from __future__ import annotations

import torch

from ._build import check, load_library


def tanimoto_similarity_reference(x: torch.Tensor,
                                  y: torch.Tensor) -> torch.Tensor:
    """Plain (n, m) Tanimoto similarity of x (n, d) and y (m, d)."""
    xy = x @ y.T
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    return xy / torch.clamp_min(x2[:, None] + y2[None, :] - xy, 1e-20)


def pack_bits_reference(x: torch.Tensor):
    """The pack kernel's output computed on the host: (words (n, W) int32,
    counts (n,) int32) for x (n, d) holding 0/1, W = ceil(d/32)."""
    n, d = x.shape
    n_words = -(-d // 32)
    bits = torch.zeros((n, 32 * n_words), dtype=torch.int64, device=x.device)
    bits[:, :d] = (x != 0).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=x.device),
        torch.arange(32, device=x.device))
    words = torch.sum(bits.reshape(n, n_words, 32) * weights, dim=-1)
    # the low 32 bits as a signed int32 pattern
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words, torch.sum(bits, dim=-1).to(torch.int32)


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"tanimoto: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"tanimoto: {name} must be float32, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"tanimoto: {name} must be (rows, d), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"tanimoto: {name} must be contiguous")
    if t.requires_grad:
        raise ValueError(
            f"tanimoto: {name} requires grad; the CUDA kernel has no backward "
            "(use tanimoto_similarity_reference where autograd must flow)")


def pack_bits(x: torch.Tensor):
    """(words (n, W) int32, counts (n,) int32) of 0/1 rows x (n, d).

    CPU tensors take the reference; CUDA tensors launch the pack kernel,
    which raises ValueError if x holds a value other than 0 or 1."""
    if x.device.type == "cpu":
        return pack_bits_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_bits: unsupported device {x.device}")
    _check_operand("x", x, x.device)
    n, d = x.shape
    words = torch.empty((n, -(-d // 32)), dtype=torch.int32, device=x.device)
    counts = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0 or d == 0:
        return words, counts.zero_()
    bad = torch.zeros((1,), dtype=torch.int32, device=x.device)
    rc = load_library().sober_pack_bits(
        x.data_ptr(), words.data_ptr(), counts.data_ptr(), bad.data_ptr(),
        n, d, torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "pack_bits")
    pack_bits.launches += 1
    if int(bad) != 0:            # host sync: popcounts are only right for 0/1
        raise ValueError("tanimoto: fingerprints must hold only 0 and 1")
    return words, counts


def tanimoto_similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) Tanimoto similarity of 0/1 rows x (n, d) and y (m, d).

    CPU tensors take the reference; CUDA tensors launch the kernels."""
    if x.device.type == "cpu":
        return tanimoto_similarity_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"tanimoto: unsupported device {x.device}")
    _check_operand("x", x, x.device)
    _check_operand("y", y, x.device)
    if x.shape[1] != y.shape[1]:
        raise ValueError(
            f"tanimoto: need x (n, d) and y (m, d), got {tuple(x.shape)} "
            f"and {tuple(y.shape)}")
    n, m = x.shape[0], y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    if x.shape[1] == 0:
        return out.zero_()
    xw, nx = pack_bits(x)
    yw, ny = (xw, nx) if y is x else pack_bits(y)
    rc = load_library().sober_tanimoto_gram(
        xw.data_ptr(), yw.data_ptr(), nx.data_ptr(), ny.data_ptr(),
        out.data_ptr(), n, m, xw.shape[1],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "tanimoto_similarity")
    tanimoto_similarity.launches += 1
    return out


pack_bits.launches = 0
tanimoto_similarity.launches = 0
