"""Run one cell of the benchmark once, on the NVIDIA GPU of this machine.

    python3 sober_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with the
keys correct, attempted, failed, metrics, device (and with --trace 1,
breakdown), then `checks`: each compared number beside its limit, which also
end standard error. Exits 2 without a result where no CUDA device is
visible, or fewer than the cell asks for, 3 where jax, jaxlib, flax or the
JAX package was loaded, and 4 where a traced run's profiled stretch holds
no device work.
"""
import time

T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for numpy's and torch's CPU work: the rounds are bound by
# the host's launches and reads, and a pool of threads that spin between
# ops on a host shared with other machines only adds to their noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    import torch

    torch.set_num_threads(1)
    from sober_bench import harness, registry

    cell = next((w for w in registry.benchmark()["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"sober_bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"sober_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        t_process = harness.process_start()
    except (OSError, ValueError, IndexError):
        t_process = T_WALL
    out, code = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_process)
    if code:
        return code
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
