"""Find configurations, cells, loops and per-layer metrics by name.

A cell is ``workloads/<name>.json``; its ``config`` names
``configs/<config>.json``, whose ``loop`` names ``loops/<loop>.py`` and whose
``module`` is the objective or data loader beside it; a per-layer metric is
``metrics/<name>.py``, or, where that file is missing, the reader of its name
without the last dotted part: ``next_batch_ms.screen`` is ``next_batch_ms``
read in a cell that reports another end-to-end metric, and BENCHMARK.json
names the metric it moves there. Modules are loaded from their files, so a
name may hold dots and dashes."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def _read(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """The module of a file under the benchmark, imported once."""
    key = "sober_bench._by_name." + (name or str(path.relative_to(ROOT)))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return _read("workloads", name)


def config(name: str) -> dict:
    return _read("configs", name)


def config_module(cfg: dict):
    """The objective or loader module a configuration names."""
    return load_module(ROOT / "configs" / cfg["module"])


def loop(name: str):
    return load_module(ROOT / "loops" / f"{name}.py")


def metric(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    if path.is_file():
        return load_module(path)
    base = name.rpartition(".")[0]
    if not base:
        raise FileNotFoundError(f"no metric named {name!r} ({path})")
    return metric(base)


def benchmark() -> dict:
    with open(REPO / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def per_layer_for(workload_name: str, bench: dict | None = None) -> list[dict]:
    """The per-layer metrics of BENCHMARK.json that a cell reports: those
    that list it, and those without a list whose end-to-end metric the
    cell reports."""
    bench = benchmark() if bench is None else bench
    reported = {m["name"] for m in bench["end_to_end"]
                if workload_name in m.get("workloads", [workload_name])}
    return [m for m in bench["per_layer"]
            if workload_name in m.get("workloads", [workload_name])
            and (m.get("workloads") is not None or m["moves"] in reported)]


def end_to_end_for(workload_name: str, bench: dict | None = None) -> list[dict]:
    bench = benchmark() if bench is None else bench
    return [m for m in bench["end_to_end"]
            if workload_name in m.get("workloads", [workload_name])]
