"""Device meshes for the port (port of sober_tpu/parallel/mesh.py).

The JAX package is single-controller SPMD: one process drives a mesh of
devices, and shard_map or GSPMD cut the arrays over its axes. The port keeps
that model in one process. A `Mesh` is an array of `torch.device`s with
named axes; a sharded array is a list of per-shard blocks, each on its
shard's device (`Sharded`); a cross-shard sum or maximum moves each shard's
partial to the mesh's first device, reduces it there and sends the result
back, all as device tensors (no host read). This is not `torch.distributed`,
which runs one process a rank.

Axes, as in the JAX package:

  * "cand": the candidate-pool axis (the long axis of every Gram strip, pi
    sweep and proposal pdf);
  * "hyper": the FBGP hypersample chains.

A mesh may name one device more than once: `make_mesh(8, devices=["cpu"] *
8)` gives eight shards on the CPU (the tests), `make_mesh(8,
devices=["cuda:0"] * 8)` eight on one card, as the JAX tests get eight
virtual CPU devices. Every per-shard block and every reduction then runs as
it would across cards, in turn on one device.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
import types
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device, one axis a name of
    `axis_names`. `shape` maps each name to its size, as JAX's Mesh.shape."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, at index 0 of every other axis: the
        shards of an array cut over `axis` and replicated over the rest."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])


def _canonical(device) -> torch.device:
    """A device with its index: torch.device("cuda") is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a, b) -> bool:
    """True if a and b name one device ("cuda" and "cuda:0" do when card 0
    is current)."""
    return _canonical(a) == _canonical(b)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("cand",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh, or a factored 2-D one, over the first n_devices devices.

    By default the devices are the visible CUDA cards (all of them without
    n_devices); with none visible this raises, never falling back to the
    CPU. An explicit `devices` list may repeat a device. Two axis names
    factor n_devices as evenly as possible, as JAX's make_mesh does."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        if n_cuda == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=[...] for a mesh on other devices")
        devices = [torch.device("cuda", i) for i in range(n_cuda)]
    devices = [_canonical(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} of "
                         f"{len(devices)} devices")
    devs = np.empty(n_devices, dtype=object)
    devs[:] = devices[:n_devices]
    axis_names = tuple(axis_names)
    if len(axis_names) == 1:
        return Mesh(devs, axis_names)
    if len(axis_names) != 2:
        raise ValueError(f"make_mesh: one or two axis names, got {axis_names}")
    a = math.isqrt(n_devices)
    while n_devices % a:
        a -= 1
    return Mesh(devs.reshape(a, n_devices // a), axis_names)


@dataclasses.dataclass(eq=False)
class Sharded:
    """An array cut into equal blocks along `dim`, block k on the k-th
    device of the mesh's `axis`."""

    blocks: list
    mesh: Mesh
    axis: str = "cand"
    dim: int = 0

    @property
    def shape(self) -> tuple:
        shape = list(self.blocks[0].shape)
        shape[self.dim] = sum(b.shape[self.dim] for b in self.blocks)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on `device` (the mesh's first by default)."""
        device = self.mesh.devices.flat[0] if device is None else device
        return torch.cat([b.to(device) for b in self.blocks], dim=self.dim)


def blocks_of(mesh: Mesh, x, axis: str = "cand", dim: int = 0) -> list:
    """The per-shard blocks of x along `dim`: a Sharded's own (its mesh
    axis must have as many shards), or a tensor's, cut into equal blocks,
    each moved to its shard's device. Raises ValueError when the mesh does
    not divide the length."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, Sharded):
        if len(x.blocks) != len(devs) or x.dim != dim:
            raise ValueError(f"a Sharded of {len(x.blocks)} blocks along dim "
                             f"{x.dim}, expected {len(devs)} along {dim}")
        return [b.to(d) for b, d in zip(x.blocks, devs)]
    n = x.shape[dim]
    if n % len(devs):
        raise ValueError(f"length {n} must be divisible by the {len(devs)} "
                         f"shards of mesh axis {axis!r}")
    return [b.to(d) for b, d in zip(torch.chunk(x, len(devs), dim=dim), devs)]


def shard_candidates(mesh: Mesh, x_cand: torch.Tensor,
                     axis: str = "cand") -> Sharded:
    """A (n_rec, ...) pool cut row-wise over `axis` (n_rec must divide)."""
    return Sharded(blocks_of(mesh, x_cand, axis), mesh, axis, 0)


def to_device(obj, device, memo: Optional[dict] = None):
    """obj with every tensor it holds on `device`: tensors, lists, tuples,
    NamedTuples, dicts, partials, bound methods and objects with a __dict__
    (shallow copies with their attributes moved). Anything already there
    comes back as itself, so on one device nothing is copied. A plain
    function's closure is not moved."""
    memo = {} if memo is None else memo
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, types.MethodType):
        owner = to_device(obj.__self__, device, memo)
        out = obj if owner is obj.__self__ else types.MethodType(obj.__func__, owner)
    elif isinstance(obj, functools.partial):
        func = to_device(obj.func, device, memo)
        args = to_device(obj.args, device, memo)
        kw = to_device(obj.keywords, device, memo)
        out = (obj if func is obj.func and args is obj.args and kw is obj.keywords
               else functools.partial(func, *args, **kw))
    elif isinstance(obj, (list, tuple)):
        items = [to_device(v, device, memo) for v in obj]
        if all(a is b for a, b in zip(items, obj)):
            out = obj
        elif hasattr(obj, "_fields"):                   # a NamedTuple
            out = type(obj)(*items)
        else:
            out = type(obj)(items)
    elif isinstance(obj, dict):
        items = {k: to_device(v, device, memo) for k, v in obj.items()}
        out = obj if all(items[k] is v for k, v in obj.items()) else items
    elif (hasattr(obj, "__dict__") and not isinstance(
            obj, (type, types.ModuleType, types.FunctionType, torch.Generator))):
        new = copy.copy(obj)
        memo[key] = new                                 # for cycles
        moved = {k: to_device(v, device, memo) for k, v in vars(obj).items()}
        if all(moved[k] is v for k, v in vars(obj).items()):
            out = obj
        else:
            vars(new).update(moved)
            out = new
    else:
        out = obj
    memo[key] = out
    return out


def replicate(mesh: Mesh, tree) -> list:
    """One copy of `tree` per device of the mesh (to_device), in the order
    of mesh.devices.flat; a device named twice gets the same object."""
    copies = {d: to_device(tree, d) for d in set(mesh.devices.flat)}
    return [copies[d] for d in mesh.devices.flat]


def reduce_to_shards(parts: Sequence[torch.Tensor], devices: Sequence,
                     op: Callable = torch.sum) -> list:
    """The cross-shard reduction of one partial per shard (psum, pmax):
    each partial is moved to the first device, `op` reduces their stack
    there (dim 0), and the result goes back to every shard's device. No
    host read."""
    total = op(torch.stack([p.to(devices[0]) for p in parts]), dim=0)
    return [total.to(d) for d in devices]


def sweep(mesh: Mesh, fn: Callable, x: torch.Tensor, axis: str = "cand",
          dim: int = 0, strict: bool = False) -> torch.Tensor:
    """fn over the rows of x shard by shard, each shard's fn (to_device) on
    its block on its own device, every shard's work enqueued before the
    results are gathered, along `dim`, on the mesh's first device. A pool
    the mesh does not divide is swept whole on the first device, as GSPMD
    leaves an uneven pool unsharded; with `strict` it raises ValueError."""
    devs = mesh.axis_devices(axis)
    if x.shape[0] % len(devs):
        if strict:
            raise ValueError(f"pool size {x.shape[0]} must be divisible by "
                             f"the {len(devs)}-shard mesh")
        return fn(x)
    fns = {d: to_device(fn, d) for d in set(devs)}
    outs = [fns[d](b) for b, d in zip(blocks_of(mesh, x, axis), devs)]
    return torch.cat([o.to(devs[0]) for o in outs], dim=dim)
