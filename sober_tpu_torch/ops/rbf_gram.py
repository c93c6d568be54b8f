"""Fused RBF Gram: `outputscale * exp(-0.5 ||x/ls - y/ls||^2)`.

`rbf_gram` is the port of `sober_tpu/ops/pallas_kernels.py:rbf_gram_pallas`.
On a CUDA tensor it launches the hand-written kernel of `csrc/rbf_gram.cu`
or raises; on a CPU tensor it computes `rbf_gram_reference`, the plain
PyTorch version (the norm-trick form of `sober_tpu/ops/kernels.py:rbf_gram`).
Like the Pallas kernel, it takes any feature width d >= 1.

Gradients with respect to x and y (the exploit polish ascends the posterior
mean in its inputs) go through `_RbfGramFn`: its forward launches the
kernel and its backward is plain PyTorch on the saved Gram
(`rbf_gram_backward`). The lengthscale and
outputscale take no gradient here: the GP fit differentiates the
reference (`neg_mll` through `KERNELS`), as the JAX package never
differentiates its Pallas kernel.
"""
from __future__ import annotations

import torch

from ._build import check, load_library


def sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distance via ||x||^2 + ||y||^2 - 2 x.y,
    clamped at 0."""
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    d2 = x2[:, None] + y2[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def rbf_gram_reference(params: dict, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Plain, differentiable RBF Gram (the kernel's reference)."""
    ls = params["lengthscale"]
    d2 = sqdist(x / ls, y / ls)
    return params["outputscale"] * torch.exp(-0.5 * d2)


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"rbf_gram: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"rbf_gram: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"rbf_gram: {name} must be contiguous")


def rbf_gram_backward(g: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      ls: torch.Tensor, k: torch.Tensor, need_x: bool = True,
                      need_y: bool = True):
    """The gradients of sum(g * K) in x and y from the Gram K itself:
    dL/dx_i = sum_j g_ij K_ij (y_j - x_i) / ls^2, and likewise in y."""
    gk = g * k
    inv = 1.0 / ls ** 2
    gx = gy = None
    if need_x:
        gx = (gk @ y - torch.sum(gk, dim=1, keepdim=True) * x) * inv
    if need_y:
        gy = (gk.T @ x - torch.sum(gk, dim=0)[:, None] * y) * inv
    return gx, gy


class _RbfGramFn(torch.autograd.Function):
    """The Gram of x and y on the card, differentiable in both: the forward
    launches the kernel, the backward is `rbf_gram_backward` on the saved
    Gram."""

    @staticmethod
    def forward(ctx, x, y, ls, os_):
        k = _launch(x, y, ls, os_)
        ctx.save_for_backward(x, y, ls, k)
        return k

    @staticmethod
    def backward(ctx, g):
        x, y, ls, k = ctx.saved_tensors
        gx, gy = rbf_gram_backward(g, x, y, ls, k, *ctx.needs_input_grad[:2])
        return gx, gy, None, None


def rbf_gram(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, m) RBF Gram of x (n, d) and y (m, d); lengthscale scalar or (d,).

    CPU tensors take the reference; CUDA tensors launch the kernel, through
    `_RbfGramFn` when x or y requires grad."""
    if x.device.type == "cpu":
        return rbf_gram_reference(params, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"rbf_gram: unsupported device {x.device}")
    ls, os_ = params["lengthscale"], params["outputscale"]
    if ls.requires_grad or os_.requires_grad:
        raise ValueError(
            "rbf_gram: the lengthscale or outputscale requires grad, which "
            "the kernel does not give (use rbf_gram_reference where autograd "
            "must reach them)")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        return _RbfGramFn.apply(x, y, ls, os_)
    return _launch(x, y, ls, os_)


def _launch(x: torch.Tensor, y: torch.Tensor, ls: torch.Tensor,
            os_: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch the kernel on the current stream."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(
            f"rbf_gram: need x (n, d) and y (m, d), got {tuple(x.shape)} "
            f"and {tuple(y.shape)}")
    n, d = x.shape
    m = y.shape[0]
    if d < 1:
        raise ValueError(f"rbf_gram: d={d}, need at least one feature")
    if ls.numel() not in (1, d) or os_.numel() != 1:
        raise ValueError(
            f"rbf_gram: lengthscale has {ls.numel()} entries for d={d}, "
            f"outputscale {os_.numel()}")
    for name, t in (("x", x), ("y", y), ("lengthscale", ls),
                    ("outputscale", os_)):
        _check_operand(name, t, x.device)
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    lib = load_library()
    # the C side launches on the current device and keeps its occupancy
    # per device: make the operands' device current
    with torch.cuda.device(x.device):
        rc = lib.sober_rbf_gram(
            x.data_ptr(), y.data_ptr(), ls.data_ptr(), os_.data_ptr(),
            out.data_ptr(), n, m, d, int(ls.numel() == d),
            torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "rbf_gram")
    rbf_gram.launches += 1
    return out


rbf_gram.launches = 0
