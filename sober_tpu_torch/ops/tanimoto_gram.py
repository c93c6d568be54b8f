"""Tanimoto similarity of 0/1 fingerprints: `|x & y| / (|x| + |y| - |x & y|)`.

`tanimoto_similarity` is the port of
`sober_tpu/ops/pallas_kernels.py:tanimoto_gram_pallas`. On a CUDA tensor it
packs each operand into 32-bit words (`pack_bits`) and launches the
tensor-core Gram of `csrc/tanimoto_gram.cu` on the words
(`tanimoto_gram_packed`), or raises; on a CPU tensor it computes
`tanimoto_similarity_reference`, the plain PyTorch version (the one-matmul
form of `sober_tpu/ops/kernels.py:tanimoto_gram`, exact for 0/1 operands in
fp32 with TF32 off).

Packed layout (the kernel's, emulated by `pack_bits_reference`): row i
becomes ceil(d/32) words; bit l of word w holds element 32w + l, and
elements past d are zero bits. Words are stored as int32 bit patterns.

Values other than 0 and 1 (NaN included). Such a row packs to the count -1,
and the Gram writes NaN in every entry of its row or column, so it never
gives a finite wrong number. On CUDA the pack also raises its device's
fingerprint flag, which no Gram reads: `check_fingerprints` reads and resets
it and raises ValueError. `Sober.next_batch` and `fit_tanimoto_gp` call it
once at their end, where they wait on the card anyway.

A pool packed once. `POOLS.register(t)` marks a long-lived operand (a
`DatasetPrior`'s features). The first Gram that takes it packs it and checks
its flag (one host read); later Grams on the same tensor, unwritten since
(`t._version`), reuse the words and counts. The registry holds the tensor by
a weak reference, so it pins nothing, and forgets it when it dies.
"""
from __future__ import annotations

import weakref
from typing import Callable

import torch

from ..utils import timing
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
    counts (n,) int32) for x (n, d), W = ceil(d/32). A row holding a value
    other than 0 or 1 gets the count -1."""
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
    bad = torch.any((x != 0) & (x != 1), dim=-1)
    return words, torch.where(bad, -1, torch.sum(bits, dim=-1)).to(torch.int32)


def tanimoto_gram_packed_reference(xw: torch.Tensor, nx: torch.Tensor,
                                   yw: torch.Tensor,
                                   ny: torch.Tensor) -> torch.Tensor:
    """The Gram kernel's function computed plainly from packed operands:
    the bits unpacked to fp32 0/1, the intersections as one (exact) matmul,
    the reference's division, and NaN in the rows and columns of count
    -1."""
    shifts = torch.arange(32, dtype=torch.int32, device=xw.device)
    unpack = lambda w: ((w[:, :, None] >> shifts) & 1).reshape(
        w.shape[0], -1).to(torch.float32)
    inter = unpack(xw) @ unpack(yw).T
    cx, cy = nx.to(torch.float32), ny.to(torch.float32)
    out = inter / torch.clamp_min(cx[:, None] + cy[None, :] - inter, 1e-20)
    return torch.where((nx < 0)[:, None] | (ny < 0)[None, :], float("nan"), out)


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"tanimoto: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"tanimoto: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"tanimoto: {name} must be contiguous")
    if t.requires_grad:
        raise ValueError(
            f"tanimoto: {name} requires grad; the CUDA kernel has no backward "
            "(use tanimoto_similarity_reference where autograd must flow)")


def _check_rows(name: str, t: torch.Tensor, device: torch.device) -> None:
    _check_operand(name, t, device)
    if t.dim() != 2:
        raise ValueError(f"tanimoto: {name} must be (rows, d), got {tuple(t.shape)}")


# one fingerprint flag per CUDA device, raised by the pack kernel
_FLAGS: dict[torch.device, torch.Tensor] = {}


def _flag(device: torch.device) -> torch.Tensor:
    if device not in _FLAGS:
        _FLAGS[device] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _FLAGS[device]


def check_fingerprints(device=None) -> None:
    """Raise ValueError if a fingerprint packed on `device` (the current
    CUDA device by default) since the last check held a value other than 0
    or 1, and reset the flag. One host read; nothing to read on the CPU or
    where nothing was packed."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not _FLAGS:
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    flag = _FLAGS.get(device)
    if flag is None:
        return
    check_fingerprints.reads += 1
    timing.count("host_reads.check_fingerprints")
    if int(flag) != 0:                      # host sync
        flag.zero_()
        raise ValueError("tanimoto: fingerprints must hold only 0 and 1")


def pack_bits(x: torch.Tensor):
    """(words (n, W) int32, counts (n,) int32) of 0/1 rows x (n, d).

    CPU tensors take the reference; CUDA tensors launch the pack kernel. A
    row holding another value gets the count -1 and, on CUDA, raises the
    device's flag for `check_fingerprints`; nothing here waits on the
    card."""
    if x.device.type == "cpu":
        return pack_bits_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_bits: unsupported device {x.device}")
    _check_rows("x", x, x.device)
    n, d = x.shape
    words = torch.empty((n, -(-d // 32)), dtype=torch.int32, device=x.device)
    counts = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0 or d == 0:
        return words, counts.zero_()
    flag = _flag(x.device)
    # the C side launches on the current device: make the operands' current
    with torch.cuda.device(x.device):
        rc = load_library().sober_pack_bits(
            x.data_ptr(), words.data_ptr(), counts.data_ptr(), flag.data_ptr(),
            n, d, torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "pack_bits")
    pack_bits.launches += 1
    return words, counts


class PackCache:
    """The packed words and counts of registered long-lived operands, made
    by `pack` at an operand's first lookup and kept while the tensor lives
    unwritten. Entries are keyed by id() and hold the tensor by a weak
    reference; an entry goes when its tensor dies."""

    def __init__(self, pack: Callable):
        self._pack = pack
        self._entries: dict[int, list] = {}    # id -> [ref, version, packed]
        self.packs = 0

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, t: torch.Tensor) -> None:
        key, entries = id(t), self._entries
        entries[key] = [weakref.ref(t, lambda _: entries.pop(key, None)),
                        None, None]

    def lookup(self, t: torch.Tensor):
        """(words, counts) of t for its current contents if t is
        registered, else None."""
        entry = self._entries.get(id(t))
        if entry is None or entry[0]() is not t:
            return None
        if entry[1] != t._version:
            entry[2] = self._pack(t)
            entry[1] = t._version
            self.packs += 1
        return entry[2]


def _pack_pool(x: torch.Tensor):
    """pack_bits and the flag's one host read: a pool is checked where it
    is packed."""
    packed = pack_bits(x)
    check_fingerprints(x.device)
    return packed


# the registry of pools that tanimoto_similarity packs once
POOLS = PackCache(_pack_pool)


def tanimoto_gram_packed(xw: torch.Tensor, nx: torch.Tensor, yw: torch.Tensor,
                         ny: torch.Tensor) -> torch.Tensor:
    """(n, m) Tanimoto similarity from packed operands: words xw (n, W) and
    yw (m, W), counts nx (n,) and ny (m,), all int32, as pack_bits gives
    them. CPU tensors take the plain version; CUDA tensors launch the Gram
    kernel."""
    if xw.device.type == "cpu":
        return tanimoto_gram_packed_reference(xw, nx, yw, ny)
    if xw.device.type != "cuda":
        raise ValueError(f"tanimoto: unsupported device {xw.device}")
    for name, t in (("xw", xw), ("nx", nx), ("yw", yw), ("ny", ny)):
        _check_operand(name, t, xw.device, torch.int32)
    if (xw.dim() != 2 or yw.dim() != 2 or xw.shape[1] != yw.shape[1]
            or tuple(nx.shape) != xw.shape[:1] or tuple(ny.shape) != yw.shape[:1]):
        raise ValueError(
            f"tanimoto: need words (n, W), (m, W) and counts (n,), (m,), got "
            f"{tuple(xw.shape)}, {tuple(yw.shape)}, {tuple(nx.shape)}, "
            f"{tuple(ny.shape)}")
    return _gram(xw, nx, yw, ny)


def _gram(xw, nx, yw, ny) -> torch.Tensor:
    """The Gram kernel's launch on packed CUDA operands already checked."""
    n, m, n_words = xw.shape[0], yw.shape[0], xw.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=xw.device)
    if n == 0 or m == 0:
        return out
    if n_words == 0:
        return out.zero_()
    # the C side launches on the current device and keeps its occupancy
    # per device: make the operands' device current
    with torch.cuda.device(xw.device):
        rc = load_library().sober_tanimoto_gram(
            xw.data_ptr(), yw.data_ptr(), nx.data_ptr(), ny.data_ptr(),
            out.data_ptr(), n, m, n_words,
            torch.cuda.current_stream(xw.device).cuda_stream)
    check(rc, "tanimoto_gram")
    tanimoto_gram_packed.launches += 1
    return out


def tanimoto_similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) Tanimoto similarity of 0/1 rows x (n, d) and y (m, d).

    CPU tensors take the reference; CUDA tensors launch the kernels, with a
    registered pool's words packed once."""
    if x.device.type == "cpu":
        return tanimoto_similarity_reference(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"tanimoto: unsupported device {x.device}")
    _check_rows("x", x, x.device)
    _check_rows("y", y, x.device)
    if x.shape[1] != y.shape[1]:
        raise ValueError(
            f"tanimoto: need x (n, d) and y (m, d), got {tuple(x.shape)} "
            f"and {tuple(y.shape)}")
    xw, nx = POOLS.lookup(x) or pack_bits(x)
    yw, ny = (xw, nx) if y is x else POOLS.lookup(y) or pack_bits(y)
    return _gram(xw, nx, yw, ny)


pack_bits.launches = 0
tanimoto_gram_packed.launches = 0
check_fingerprints.reads = 0
