"""Read the correctness check's numbers over many seeds in one process, on
the card: first the program as the configuration states it, then the
program with each planted fault (faults.py), then its control, the program
with TF32 matmuls switched on (the nearest precision below the
configuration's float32 with TF32 off). The limits in workloads/<cell>.json
are set from these readings (PERF.md gives them).

    python3 sober_bench/readings.py --workload <name> --seeds 1,2,3 \
        [--faults unchanged_state,altered_index --fault-seeds 7,8,9 \
         --fault-seconds 25] --control-seeds 4,5,6 --seconds 50 [--out FILE]

One JSON line a seed: the mode, the rounds in the window, round_s and each
compared number (the widest over the checked rounds). The benchmark's own
runs never run the control.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_on() -> None:
    """TF32 for float32 matmuls and convolutions: the control's precision."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def read_seed(cell, seed: int, seconds: float, mode: str) -> dict:
    import torch

    window_s, starts, _, records, peak, _ = cell.measure(seed, seconds)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        correct, checks, failed = cell.judge(records)
        numbers = {k: v for k, (v, _) in checks.items()}
        numbers["rounds"] = cell.last_rounds
    except Exception as err:  # a control that crashes has failed: no number
        correct, numbers, failed = False, {"error": repr(err)}, None
    return {"mode": mode, "seed": seed, "rounds": len(starts), "records": len(records),
            "round_s": window_s / max(len(starts), 1), "peak_gib": peak / 2**30,
            "judge_s": time.perf_counter() - t0, "correct": correct, "numbers": numbers}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=50.0)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--fault-seconds", type=float, default=25.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    torch.set_num_threads(1)
    from sober_bench import faults, harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload, "cuda")
    cell.warm()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    out = open(args.out, "a", encoding="utf-8") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        emit(read_seed(cell, seed, args.seconds, "program"))
    for name in [f for f in args.faults.split(",") if f]:
        for seed in fault_seeds:
            with faults.planted(cell, name):
                emit(read_seed(cell, seed, args.fault_seconds, name))
    if controls:
        control_on()
    for seed in controls:
        emit(read_seed(cell, seed, args.seconds, "control"))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
