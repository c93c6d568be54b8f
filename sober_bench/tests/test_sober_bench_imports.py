"""After the harness and every module of the port that a run loads are
imported, and a round of each cell has run, no module of the process has
the top-level name jax, jaxlib, flax or sober_tpu (compared whole: the port
sober_tpu_torch begins with sober_tpu)."""
import subprocess
import sys

from tiny import REPO

PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/sober_bench/tests")
import torch
from sober_bench import harness, readings, registry, trace
from tiny import cell
for name in ("shekel-b100", "solvent-b100"):
    c = cell(name)
    ep = c.loop.start(1, c.probe)
    c.round(ep)
    for m in registry.per_layer_for(name):
        registry.metric(m["name"])
tops = sorted({m.split(".")[0] for m in sys.modules})
assert "sober_tpu_torch" in tops
print("FOUND", harness.forbidden_modules())
"""


def test_no_jax_and_no_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE, REPO], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []", out.stdout[-2000:]


def test_the_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, REPO)
    from sober_bench import harness

    monkeypatch.setitem(sys.modules, "sober_tpu_torch_fake", sys)
    assert "sober_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()
