"""Checkpoint and resume of the optimization state (port of
sober_tpu/utils/checkpoint.py).

A nested structure of dicts, lists, tuples and NamedTuples whose leaves are
tensors, arrays or Python scalars is saved as one `.npz` in the JAX
package's layout: `leaf_i` for the i-th leaf in flattening order (dict keys
sorted), `__paths__` a JSON list of their paths ("['x_all']",
"['gp_params']/.raw_noise", ...) and `__metadata__` a JSON dict. The loop's
random state is the CPU generator state of its `KeyRing` (a uint8 tensor)
where the JAX package keeps its key data.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """[(path, leaf)] in the JAX package's order and path notation."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (f"[{k!r}]",))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _flatten(getattr(tree, name), prefix + (f".{name}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (f"[{i}]",))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """A structure like `like` with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, n), leaves) for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: Any, metadata: dict | None = None):
    """Save a structure of tensors, arrays and scalars (and JSON metadata)
    to `path`.npz."""
    flat = _flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    arrays["__paths__"] = np.asarray(json.dumps([p for p, _ in flat]))
    if metadata is not None:
        arrays["__metadata__"] = np.asarray(json.dumps(metadata))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_checkpoint(path: str, like: Any):
    """Load a checkpoint of save_checkpoint into the structure of `like`:
    a tensor leaf comes back with the dtype and device of `like`'s, an array
    as an array, a scalar as the scalar's type. Returns (state, metadata)."""
    with np.load(_npz(path), allow_pickle=False) as data:
        refs = [leaf for _, leaf in _flatten(like)]
        new = []
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if isinstance(ref, torch.Tensor):
                new.append(torch.as_tensor(arr, dtype=ref.dtype, device=ref.device))
            elif isinstance(ref, np.ndarray):
                new.append(arr.astype(ref.dtype))
            else:
                new.append(type(ref)(arr.item()))
        metadata = (json.loads(str(data["__metadata__"]))
                    if "__metadata__" in data else None)
    return _unflatten(like, iter(new)), metadata


def save_loop_state(path: str, x_all, y_all, gen: torch.Generator,
                    gp_params=None, extra: dict | None = None):
    """The Sober loop's state: observations, the generator state and the
    fitted GP hypers if given."""
    state = {"x_all": x_all, "y_all": y_all, "key": gen.get_state()}
    if gp_params is not None:
        state["gp_params"] = gp_params
    save_checkpoint(path, state, metadata=extra)


def load_loop_state(path: str, device=None):
    """(state, metadata): state maps each top-level name to a tensor on
    `device` (the CPU unless given; a nested leaf under its full path), and
    "key" to the CPU uint8 generator state (`torch.Generator.set_state`)."""
    with np.load(_npz(path), allow_pickle=False) as data:
        paths = json.loads(str(data["__paths__"]))
        state: dict = {}
        for i, p in enumerate(paths):
            # dict paths render as "['name']...": the first quoted token
            name = p.split("'")[1] if "'" in p else p
            state[p if name in state else name] = torch.as_tensor(data[f"leaf_{i}"])
        metadata = (json.loads(str(data["__metadata__"]))
                    if "__metadata__" in data else None)
    key = state.pop("key").to(torch.uint8)
    state = {k: v.to(device) if device is not None else v for k, v in state.items()}
    state["key"] = key
    return state, metadata
