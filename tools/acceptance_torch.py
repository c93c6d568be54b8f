"""Reference-config acceptance runs of the PyTorch/CUDA port: best-value
trajectories and wall-clock (the port's twin of tools/acceptance.py).

Runs each task at the reference's published config (n_init 100, 15
iterations, batch and n_rec per task: TASKS) for seeds 0, 1 and 2 through
the torch example scripts (examples_torch/), appending one JSON line per
(task, seed) to docs/acceptance_runs_torch.jsonl, never to the JAX
package's docs/acceptance_runs.jsonl. The rows have the JAX rows' keys plus
"backend" ("cuda" or "cpu"), "device_name" and "power_limit" (nvidia-smi's
name and power.limit of the card; None on the CPU). A (task, seed) already
in the file is skipped, so a cut run resumes where it stopped. A task that
raises stops the tool with a non-zero exit code. With --history DIR each
run's observations (x, y) are also saved, as DIR/<task>_seed<seed>.npz.

svm's objective needs scikit-learn, which a PyTorch-only GPU install need
not carry: it runs only with --device cpu.

Usage: python tools/acceptance_torch.py [--device cuda|cpu] [--out PATH]
       [--seeds 0,1,2] [--history DIR] [task ...]
       (default: every task the device runs, seeds 0, 1 and 2)
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT = os.path.join(ROOT, "docs", "acceptance_runs_torch.jsonl")
SEEDS = (0, 1, 2)

# (kind, script or setup, config): the REFERENCE's configs
# (examples/<task>.py:68-72 of the reference; tools/acceptance.py:132-155);
# the example scripts default some batch sizes to 100, so the reference
# values are passed explicitly
TASKS = {
    "ising": ("example", "ising", dict(batch_size=200, n_rec=200000)),
    "maxsat": ("example", "maxsat", dict(batch_size=200, n_rec=20000)),
    "pest": ("example", "pest", dict(batch_size=200, n_rec=100000)),
    "rosenbrock": ("example", "rosenbrock", dict(batch_size=100, n_rec=20000)),
    "shekel": ("example", "shekel", dict(batch_size=100, n_rec=200000)),
    "ackley": ("example", "ackley", dict(batch_size=200, n_rec=20000)),
    "svm": ("example", "svm", dict(n_init=100, batch_size=200, n_rec=20000,
                                   n_iterations=15)),
    "malaria": ("dataset", "setup_malaria", dict(n_rec=20000, batch_size=100)),
    "solvent": ("dataset", "setup_solvent", dict(n_rec=20000, batch_size=200)),
}
CPU_ONLY = {"svm"}


def device_fields(device: torch.device) -> dict:
    """The row's backend, and the card's name and power limit as nvidia-smi
    gives them (the CPU's processor and None on the CPU)."""
    if device.type != "cuda":
        return {"backend": "cpu", "device_name": platform.processor() or "cpu",
                "power_limit": None}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
        name, power = (s.strip() for s in line.split(",", 1))
    except (OSError, subprocess.CalledProcessError, ValueError):
        name, power = torch.cuda.get_device_name(device), None
    return {"backend": "cuda", "device_name": name, "power_limit": power}


def record(out, task, seed, cfg, history, wall_s, telemetry, fields):
    row = {
        "task": task, "seed": seed, "cfg": cfg,
        "best_per_iter": [round(b, 6) for _, b in history],
        "acq_s_per_iter": [round(t, 4) for t, _ in history],
        "wall_s": round(wall_s, 2),
        # the stagnation resets, the positive-weight pool counts and the
        # path of each iteration
        "resets_per_iter": [int(t["reset"]) for t in telemetry],
        "n_pos_per_iter": [t["n_pos"] for t in telemetry],
        "path_per_iter": [t["path"] for t in telemetry],
        **fields,
    }
    with open(out, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(f"[{task} seed={seed}] best={row['best_per_iter'][-1]} "
          f"wall={wall_s:.1f}s", flush=True)
    return row


def _full_bucket(cfg: dict) -> int:
    """One observation bucket covering the whole run, so the padded GP
    shapes stay fixed across iterations and seeds."""
    n_max = (cfg.get("n_init", 100)
             + cfg.get("batch_size", 100) * cfg.get("n_iterations", 15))
    return ((n_max + 127) // 128) * 128


def already_done(out, task, seed) -> bool:
    if not os.path.exists(out):
        return False
    with open(out) as f:
        return any((row["task"], row["seed"]) == (task, seed)
                   for row in map(json.loads, f))


def run_task(task: str, out: str = OUT, device=None, seeds=SEEDS,
             history: str | None = None, **overrides) -> list:
    """Runs `task` for each seed not yet in `out` at its reference config
    updated with `overrides`; returns the rows written. With `history`, a
    directory, each run's observations are saved there too."""
    from sober_tpu_torch.config import resolve_device

    device = resolve_device(device)
    if task in CPU_ONLY and device.type != "cpu":
        raise ValueError(f"{task} runs only with --device cpu (its objective "
                         "needs scikit-learn)")
    kind, target, ref = TASKS[task]
    cfg = {**ref, **overrides}
    fields = device_fields(device)
    rows = []
    for seed in seeds:
        if already_done(out, task, seed):
            continue
        t0 = time.monotonic()
        telemetry = []
        if kind == "example":
            mod = importlib.import_module(f"examples_torch.{target}")
            x_all, y_all, trace = mod.main(device=device, seed=seed, verbose=False,
                                           telemetry=telemetry,
                                           gp_kwargs={"bucket": _full_bucket(cfg)},
                                           **cfg)
            row_cfg = cfg
        else:
            from examples_torch.common import run_dataset_loop
            from sober_tpu_torch import tasks

            dcfg = {"n_init": 100, "batch_size": 100, "n_nys": 500,
                    "n_iterations": 15, **cfg}
            n_pool = dcfg.pop("n_pool", None)
            prior = getattr(tasks, target)(n_pool=n_pool, device=device)
            x_all, y_all, trace = run_dataset_loop(
                prior, seed=seed, bucket=_full_bucket(dcfg), verbose=False,
                telemetry=telemetry, **dcfg)
            row_cfg = {**cfg, "fingerprints": tasks.fingerprint_route()}
        rows.append(record(out, task, seed, row_cfg, trace,
                           time.monotonic() - t0, telemetry, fields))
        if history is not None:
            os.makedirs(history, exist_ok=True)
            np.savez(os.path.join(history, f"{task}_seed{seed}.npz"),
                     x=x_all.cpu().numpy(), y=y_all.cpu().numpy())
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tasks", nargs="*", help=f"default: all of {list(TASKS)} "
                    "that the device runs")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)),
                    help="comma-separated (default: %(default)s)")
    ap.add_argument("--history", help="a directory for each run's observations")
    args = ap.parse_args(argv)
    names = args.tasks or [t for t in TASKS
                           if args.device == "cpu" or t not in CPU_ONLY]
    for name in names:
        print(f"=== {name}", flush=True)
        run_task(name, out=args.out, device=args.device,
                 seeds=tuple(int(s) for s in args.seeds.split(",")),
                 history=args.history)


if __name__ == "__main__":
    main()
