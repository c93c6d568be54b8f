"""Faults planted in the timed path, to see the check come out false and to
read the check's numbers under them (readings.py --faults; the tests):
each is a context manager that patches the program from outside and puts
it back.

  unchanged_state: the fit returns its starting hypers (no step taken);
  half_batch:      recombination keeps half of the batch, the weights
                   renormalized over the rest;
  altered_index:   one index of the batch replaced, where recombination
                   produces it, by a pool row it did not choose;
  altered_weights: the batch's weights scaled by up to 1.5, renormalized.

No exchange between chips exists in a one-chip cell, so there is no fault
for it.
"""
import contextlib
import dataclasses
import importlib

import torch

NAMES = ("unchanged_state", "half_batch", "altered_index", "altered_weights")


def _half(inner):
    def run(*args, **kwargs):
        idx, w = inner(*args, **kwargs)
        k = idx.shape[0] // 2
        return idx[:k], w[:k] / w[:k].sum()
    return run


def _altered_index(inner):
    def run(x_cand, *args, **kwargs):
        idx, w = inner(x_cand, *args, **kwargs)
        unused = torch.ones(x_cand.shape[0], dtype=torch.bool, device=idx.device)
        unused[idx] = False
        idx = idx.clone()
        idx[0] = torch.nonzero(unused)[-1, 0]
        return idx, w
    return run


def _altered_weights(inner):
    def run(*args, **kwargs):
        idx, w = inner(*args, **kwargs)
        g = torch.Generator(device=w.device).manual_seed(1)
        w = w * (1 + 0.5 * torch.rand(w.shape, generator=g, device=w.device))
        return idx, w / w.sum()
    return run


@contextlib.contextmanager
def planted(cell, name: str):
    """The fault `name` in `cell`'s timed path inside the block."""
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; have {NAMES}")
    loop = cell.loop
    if name == "unchanged_state":
        saved = ("gp_cfg", loop.gp_cfg) if hasattr(loop, "gp_cfg") else ("gp", loop.gp)
        if hasattr(loop, "gp_cfg"):
            loop.gp_cfg = dataclasses.replace(loop.gp_cfg, fit_iters=0)
            loop.gp = dict(loop.gp, optimiser="adam")
        else:
            loop.gp = dict(loop.gp, fit_iters=0, optimiser="adam")
        gp = loop.gp
        try:
            yield
        finally:
            setattr(loop, *saved)
            if saved[0] == "gp_cfg":
                loop.gp = dict(gp, optimiser=cell.config["gp"]["optimiser"])
        return
    sampler = importlib.import_module("sober_tpu_torch.core.sampler")
    inner = sampler.recombination
    sampler.recombination = {"half_batch": _half, "altered_index": _altered_index,
                             "altered_weights": _altered_weights}[name](inner)
    try:
        yield
    finally:
        sampler.recombination = inner
