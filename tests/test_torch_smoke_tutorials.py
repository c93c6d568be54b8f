"""The torch tutorials (tutorials_torch/) on the CPU.

Each tutorial runs end to end with device="cpu" at tests/test_smoke.py's
tiny budget for its JAX twin. Its config is held to the twin's without
running either at full width: main's keywords and defaults equal the
twin's (plus device), and the first heavy call of each main, replaced by a
recorder, receives the same arguments in both (arrays compared by shape).
Tutorial 02's deterministic values are held to the twin's printed ones.

One departure is deliberate: tutorial 08's loop updates TurBO's trust
region with each batch's values, which its twin's never does (the twin
tests a key its state dict lacks), so TurBO's batches after the first
differ between the two. The parity case stubs the loop and holds the
config only.
"""
import re

import numpy as np
import pytest
import torch
from torch_script_parity import BUDGETS, assert_config_matches, few_threads, load  # noqa: F401

SCRIPTS = sorted(p.removeprefix("tutorials/") for p in BUDGETS if p.startswith("tutorials/"))
# the first heavy call of each main (tutorial 02 makes none)
FIRST_CALL = {"00_quick_start.py": "fit_gp_padded", "01_how_sober_works.py": "fit_gp_padded",
              "03_customise_acquisition.py": "fit_gp_padded",
              "04_fully_bayesian_gp.py": "FitboGP",
              "05_simulation_based_inference.py": "fit_gp_padded",
              "06_drug_discovery.py": "setup_malaria", "07_compare_thompson_sampling.py": "run",
              "08_benchmark_batch_bo.py": "loop", "advanced_01_bolfi.py": "SoberWrapper"}


@pytest.mark.smoke
@pytest.mark.parametrize("script", SCRIPTS)
def test_config_matches_jax(script, monkeypatch):
    """main's keywords and defaults, and what main hands its first heavy
    call when called with no overrides, equal the JAX twin's."""
    assert_config_matches("tutorials/" + script, "tutorials_torch/" + script,
                          FIRST_CALL.get(script), monkeypatch)


@pytest.mark.smoke
@pytest.mark.parametrize("script", SCRIPTS)
def test_tutorial_runs_on_cpu(script):
    """The tutorial at its JAX twin's tiny budget, on the CPU."""
    budget = BUDGETS["tutorials/" + script]
    out = load("tutorials_torch/" + script).main(device="cpu", **budget)
    if script == "01_how_sober_works.py":
        assert out.shape == (budget["batch_size"], 2) and bool(torch.isfinite(out).all())
    elif script in ("05_simulation_based_inference.py", "advanced_01_bolfi.py"):
        assert bool(torch.isfinite(out).all())
    elif script in ("07_compare_thompson_sampling.py", "08_benchmark_batch_bo.py"):
        assert len(out) == len(budget.get("methods", out)) and all(
            np.isfinite(v) for v in out.values())
    elif script == "02_customise_prior.py":
        assert out["n_available"] == 8
    elif out is not None:
        assert np.isfinite(out)


def _printed(text):
    """Tutorial 02's deterministic values from its printed lines."""
    num = r"-?\d+(?:\.\d*)?(?:e-?\d+)?"
    grab = lambda label: [float(v) for v in re.findall(
        num, re.search(label + r":(.*)", text).group(1))]
    return {"gaussian pdf at 0": grab("gaussian pdf at 0"),
            "truncated constant": grab("truncated constant"),
            "dataset queried": grab("dataset queried")}


@pytest.mark.smoke
def test_customise_prior_values_match_jax(capsys):
    """Tutorial 02's Gaussian pdf at 0, truncated constant, dataset query
    and remaining count, against its JAX twin's, within 1e-5."""
    load("tutorials/02_customise_prior.py").main()
    want = _printed(capsys.readouterr().out)
    load("tutorials_torch/02_customise_prior.py").main(device="cpu")
    got = _printed(capsys.readouterr().out)
    assert want["dataset queried"] == [3.0, 5.0, 8.0]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)
