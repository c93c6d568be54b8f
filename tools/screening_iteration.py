"""Time the dataset screening iteration with the sober_tpu_torch of a given
checkout, on one CUDA device.

    python3 tools/screening_iteration.py [--root DIR] [--iters N]

`Sober.next_batch` at bench.py:bench_dataset's configuration, as
`chip_smoke.py` builds it: the pool of 133,303 x 2048-bit fingerprints
(numpy seed 0), the Tanimoto GP fitted on 512 of its rows, then one warm-up
and N timed calls, each by host clock around a device sync. Then the
device's busy time over 5 more calls, by torch.profiler. The package comes
from DIR (default: this checkout), so running the script once per checkout,
in turns, compares two trees on one card. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--iters", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("screening_iteration: needs a CUDA device")
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from sober_tpu_torch import DatasetPrior, Sober, fit_tanimoto_gp
    from sober_tpu_torch.utils.prng import KeyRing

    _, _, _, n_obs, n_rec, n_nys, batch = smoke.DATASET
    pool, targets = smoke.make_pool()
    dev = torch.device("cuda")
    prior = DatasetPrior(pool, targets, device=dev)
    x_obs, y_obs = prior.sample(KeyRing(0, device=dev).next(), n_obs)
    sober = Sober(prior, fit_tanimoto_gp(x_obs, y_obs),
                  kernel_type="weighted_predictive_covariance")
    times = []
    for it in range(1 + args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sober.next_batch(n_rec, n_nys, batch)
        torch.cuda.synchronize()
        if it:
            times.append(1e3 * (time.perf_counter() - t0))
    prof = smoke.car_profile(
        lambda: [sober.next_batch(n_rec, n_nys, batch) for _ in range(5)])
    busy = prof["all_device_ms"] / 5 if prof["all_device_ms"] else None
    median = statistics.median(times)
    print(json.dumps({
        "root": str(args.root), "iters": args.iters, "iteration_ms_median": median,
        "iteration_ms_mean": statistics.mean(times),
        "iteration_ms_quartiles": statistics.quantiles(times, n=4),
        "device_busy_ms_per_iteration": busy,
        "device_idle_share": None if busy is None else 1 - busy / median,
        "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
