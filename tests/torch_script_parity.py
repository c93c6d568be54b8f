"""Shared harness of tests/test_torch_smoke_examples.py and
tests/test_torch_smoke_tutorials.py: loading a script as a module, the JAX
scripts' tiny budgets, and the recorder that holds what a script's main
hands its first heavy call to its JAX twin's."""
import importlib.util
import inspect
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(relpath):
    """The script at `relpath` of the repository as a module of its own."""
    path = os.path.join(ROOT, relpath)
    name = "torch_smoke_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# the JAX scripts' tiny budgets, read from tests/test_smoke.py
BUDGETS = dict(load("tests/test_smoke.py").SCRIPTS)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The scripts' tensors are small at these budgets, and a test worker
    shares the host's cores with the others: two threads a worker run them
    many times faster than one a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Recorded(Exception):
    pass


def summary(v):
    """A value as the two packages can agree on it: an array by its shape
    (by its values when it has at most 8), a device mesh by its axis names
    (its size is the host's device count), an object by its class name."""
    if hasattr(v, "axis_names") and hasattr(v, "devices"):
        return ("mesh", tuple(v.axis_names))
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        return ("array", a.shape, a.round(6).tolist() if a.size <= 8 else None)
    if isinstance(v, dict):
        return {k: summary(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [summary(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return ("callable",) if callable(v) else ("object", type(v).__name__)


def first_call(mod, name, monkeypatch, **kwargs):
    """Calls mod.main(**kwargs) with mod.<name> replaced by a recorder, and
    returns the summarized arguments the recorder received (tutorial 08's
    loop reads its config from the module: BATCH, POOL, ITERS)."""
    def recorder(*args, **kw):
        kw.pop("device", None)
        if name == "loop":
            raise Recorded((mod.BATCH, mod.POOL, mod.ITERS, list(mod.METHODS)))
        raise Recorded(summary(list(args)), summary(kw))

    monkeypatch.setattr(mod, name, recorder)
    with pytest.raises(Recorded) as rec:
        mod.main(**kwargs)
    return rec.value.args


def main_keywords(main):
    """main's parameters but `device`: names, kinds and defaults."""
    return [(p.name, p.kind, p.default) for p in inspect.signature(main).parameters.values()
            if p.name != "device"]


def assert_config_matches(twin, script, first, monkeypatch):
    """The torch script takes `device` and its JAX twin's keywords and
    defaults, and its main hands `first` (a name in its module, or None)
    what the twin's hands it, both called with no overrides."""
    jmod, tmod = load(twin), load(script)
    assert "device" in inspect.signature(tmod.main).parameters
    assert main_keywords(tmod.main) == main_keywords(jmod.main)
    if first is not None:
        want = first_call(jmod, first, monkeypatch)
        assert first_call(tmod, first, monkeypatch, device="cpu") == want
