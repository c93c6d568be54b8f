"""The torch example scripts (examples_torch/) and tools/acceptance_torch.py
on the CPU.

Each script runs end to end with device="cpu" at tests/test_smoke.py's tiny
budget for its JAX twin. Its config is held to the twin's without running
either at full width: main's keywords and defaults equal the twin's (plus
device), and the first heavy call of each main, replaced by a recorder,
receives the same arguments in both (arrays compared by shape). The
acceptance tool runs a tiny config into a temporary file, with rows keyed
as the JAX package's rows plus the backend and the device, and resumes.
"""
import json
import sys

import numpy as np
import pytest
import torch
from torch_script_parity import BUDGETS, ROOT, assert_config_matches, few_threads, load  # noqa: F401

SCRIPTS = sorted(p.removeprefix("examples/") for p in BUDGETS if p.startswith("examples/"))
BO_LOOP = ["ackley.py", "branin.py", "hartmann.py", "ising.py", "maxsat.py",
           "pest.py", "rosenbrock.py", "shekel.py", "svm.py"]
# the first heavy call of each main
FIRST_CALL = {"malaria.py": "setup_malaria", "solvent.py": "setup_solvent",
              "fbgp_hartmann.py": "FitboGP", "sbi_ecm.py": "fit_gp",
              "multichip.py": "Sober", **{s: "run_bo_loop" for s in BO_LOOP}}
# the mesh's size on the CPU: JAX's twin takes tests/conftest.py's 8 devices
CPU_EXTRA = {"multichip.py": {"n_devices": 8}}


def _fitted_marker(*args, **kwargs):
    return "fitted GP"


@pytest.mark.smoke
@pytest.mark.parametrize("script", SCRIPTS)
def test_config_matches_jax(script, monkeypatch):
    """main's keywords and defaults, and what main hands its first heavy
    call when called with no overrides, equal the JAX twin's. multichip's
    Sober receives its mesh and schedule; the GP it is handed is fitted on
    each package's own random initial design, so both fits are replaced by
    a marker."""
    if script == "multichip.py":
        import sober_tpu.gp.exact
        import sober_tpu_torch.gp.exact

        for module in (sober_tpu.gp.exact, sober_tpu_torch.gp.exact):
            monkeypatch.setattr(module, "fit_gp_padded", _fitted_marker)
    assert_config_matches("examples/" + script, "examples_torch/" + script,
                          FIRST_CALL[script], monkeypatch)


@pytest.mark.smoke
@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_cpu(script):
    """The script at its JAX twin's tiny budget, on the CPU."""
    budget = BUDGETS["examples/" + script]
    out = load("examples_torch/" + script).main(device="cpu", **budget,
                                                  **CPU_EXTRA.get(script, {}))
    if script == "multichip.py":
        assert len(out) == budget["n_iterations"]
        assert all(np.isfinite(best) and sec > 0 for best, sec in out)
    elif script in BO_LOOP or script in ("malaria.py", "solvent.py"):
        x_all, y_all, history = out
        n = budget["n_init"] + budget["batch_size"] * budget["n_iterations"]
        assert x_all.shape[0] == y_all.shape[0] == n and len(history) == 1
        assert bool(torch.isfinite(x_all).all() & torch.isfinite(y_all).all())
    elif script == "fbgp_hartmann.py":
        x_all, _ = out
        assert x_all.shape == (budget["n_init"] + budget["batch_size"], 6)
        assert bool(((x_all >= 0) & (x_all <= 1)).all())
    else:
        assert out.shape == (5,) and bool(torch.isfinite(out).all())


def test_svm_names_its_missing_dependency(monkeypatch):
    """Without scikit-learn the svm script raises ImportError naming it."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        load("examples_torch/svm.py").main(device="cpu")


# ----------------------------------------------------------------------------
# tools/acceptance_torch.py
# ----------------------------------------------------------------------------

TINY_ACCEPTANCE = dict(n_init=16, batch_size=8, n_rec=512, n_nys=32, n_iterations=2)


@pytest.mark.smoke
def test_acceptance_rows_and_resume(tmp_path):
    """Two seeds of Shekel and one of malaria (a 2048-row pool) at a tiny
    config: one row each with the JAX rows' keys plus the backend and the
    device, written to the given file only; a second call skips them."""
    acc = load("tools/acceptance_torch.py")
    with open(f"{ROOT}/docs/acceptance_runs.jsonl") as f:
        jax_keys = set(json.loads(f.readline()))
    out = str(tmp_path / "rows.jsonl")
    rows = acc.run_task("shekel", out=out, device="cpu", seeds=(0, 1), **TINY_ACCEPTANCE)
    rows += acc.run_task("malaria", out=out, device="cpu", seeds=(0,), n_pool=2048,
                         **TINY_ACCEPTANCE)
    with open(out) as f:
        written = [json.loads(line) for line in f]
    assert written == rows and [(r["task"], r["seed"]) for r in rows] == [
        ("shekel", 0), ("shekel", 1), ("malaria", 0)]
    for row in rows:
        assert set(row) == jax_keys | {"backend", "device_name", "power_limit"}
        assert row["backend"] == "cpu" and row["power_limit"] is None
        assert len(row["best_per_iter"]) == len(row["n_pos_per_iter"]) == 2
        assert row["best_per_iter"][1] >= row["best_per_iter"][0]
    assert rows[2]["cfg"]["fingerprints"] in ("rdkit", "ngram")
    assert acc.run_task("shekel", out=out, device="cpu", seeds=(0, 1),
                        **TINY_ACCEPTANCE) == []
    with open(out) as f:
        assert len(f.readlines()) == 3


@pytest.mark.smoke
def test_acceptance_saves_the_history(tmp_path):
    """With a history directory, each run's observations are saved beside
    its row: the initial design and every batch, whose best is the row's
    last best."""
    acc = load("tools/acceptance_torch.py")
    (row,) = acc.run_task("ackley", out=str(tmp_path / "rows.jsonl"), device="cpu",
                          seeds=(3,), history=str(tmp_path / "runs"), **TINY_ACCEPTANCE)
    run = np.load(tmp_path / "runs" / "ackley_seed3.npz")
    assert run["x"].shape == (16 + 2 * 8, 23) and run["y"].shape == (16 + 2 * 8,)
    assert row["seed"] == 3
    np.testing.assert_allclose(run["y"].max(), row["best_per_iter"][-1], atol=1e-6)


def test_acceptance_keeps_svm_on_the_cpu(tmp_path):
    """svm on the card is refused before anything runs, and its task table
    is the JAX tool's."""
    acc = load("tools/acceptance_torch.py")
    with pytest.raises(ValueError, match="cpu"):
        acc.run_task("svm", out=str(tmp_path / "rows.jsonl"), device="cuda")
    assert not (tmp_path / "rows.jsonl").exists()
    assert set(acc.TASKS) == {"ising", "maxsat", "pest", "rosenbrock", "shekel",
                              "ackley", "svm", "malaria", "solvent"}
    assert acc.SEEDS == (0, 1, 2)
