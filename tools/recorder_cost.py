"""What the program's recorder (sober_tpu_torch/utils/timing.py) costs on one
CUDA device, and what its records say about the benchmark's cells.

    python3 tools/recorder_cost.py [--seconds 30] [--cells shekel-b100,solvent-b100]
                                   [--out chiprun_out/recorder_cost.jsonl]

1. The host cost of a span and of a counter, off and on (on: a pair of
   CUDA events a span), in microseconds a call.
2. For each cell of sober_bench (harness.Cell, used as a library; nothing
   in the benchmark is switched): the warm episode, then four windows of
   --seconds, recorder off, on, on, off, the first pair on one seed and the
   second on another; each window's round seconds (window / rounds, as
   round_s). From the windows with the recorder on: each stage's stream and
   host time and the share of it that its children's self times cover
   (next_batch.candidates, recombination, fit), and the prog.* readers.
3. One more episode with the recorder on, each fit and next_batch under
   torch.cuda's sync debug mode: every synchronizing operation by the file
   and line that made it, beside the call's host_reads.* counters.

One JSON line per item, printed and appended to --out.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
import timeit
import warnings
from pathlib import Path

# one host thread, as the benchmark's command runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sober_bench import harness, registry  # noqa: E402
from sober_tpu_torch.utils import timing  # noqa: E402

# each stage, and the prefixes of the spans its children's self times sum
COVER = {"next_batch.candidates": ("sampler.",),
         "recombination": ("recombination.",),
         "fit": ("fit.",)}
SEEDS = (2_147_480_001, 1_999_999_937)


def emit(out: Path, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    with open(out, "a", encoding="utf-8") as f:
        f.write(line + "\n")


def host_costs(device: torch.device) -> dict:
    """Microseconds a span enter and exit, and a counter, off and on."""
    n = 20_000

    def spans():
        for _ in range(n):
            with timing.span("cost.span"):
                pass

    def counts():
        for _ in range(n):
            timing.count("cost.count")

    timing.disable()
    off_span = min(timeit.repeat(spans, number=1, repeat=5)) / n * 1e6
    off_count = min(timeit.repeat(counts, number=1, repeat=5)) / n * 1e6
    timing.enable(device)
    on_span = min(timeit.repeat(spans, number=1, repeat=5)) / n * 1e6
    on_count = min(timeit.repeat(counts, number=1, repeat=5)) / n * 1e6
    timing.TRACE.reset()
    timing.disable()
    return {"span_off_us": off_span, "count_off_us": off_count,
            "span_on_us": on_span, "count_on_us": on_count}


def coverage(summary: dict) -> dict:
    """Per stage: its stream and host seconds, and the share of each that
    the self times of its children (the spans under its prefix) cover."""
    out = {}
    for stage, prefixes in COVER.items():
        row = summary.get(stage)
        if row is None:
            continue
        kids = [s for name, s in summary.items() if name.startswith(prefixes)]
        host_kids = sum(s["self_s"] for s in kids)
        entry = {"host_s": row["total_s"], "host_cover": host_kids / row["total_s"]}
        if row["stream_s"]:
            stream_kids = sum(s["stream_self_s"] or 0.0 for s in kids)
            entry.update(stream_s=row["stream_s"], stream_cover=stream_kids / row["stream_s"])
        out[stage] = entry
    return out


def readers(cell_name: str) -> dict:
    names = [m["name"] for m in registry.per_layer_for(cell_name)
             if m["name"].startswith("prog.")]
    return {n: registry.metric(n).read(harness.Readings()) for n in names}


def sync_sites(cell: harness.Cell, seed: int, rounds: int) -> list:
    """Each fit and next_batch of an episode under sync debug mode: the
    synchronizing operations by site, and the call's host_reads counters."""
    loop, rows = cell.loop, []

    def watched(kind, fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = collections.Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchronizing" in str(w.message))
        call = timing.TRACE.calls()[-1]
        counted = {k: v for k, v in call["counts"].items() if k.startswith("host_reads.")}
        rows.append({"kind": kind, "synced": sum(sites.values()),
                     "counted": sum(counted.values()), "sites": dict(sites),
                     "counters": counted})
        return out

    ep = loop.start(seed, cell.probe)
    for _ in range(rounds):
        model = watched("fit", lambda: loop.fit(ep))
        loop.update(ep, model, cell.probe)
        out = watched("next_batch", lambda: loop.next_batch(ep))
        loop.observe(ep, out)
    cell.sync()
    return rows


def run_cell(name: str, seconds: float, device, traffic, out: Path) -> None:
    cell = harness.Cell(name, device, traffic=traffic)
    t0 = time.perf_counter()
    cell.warm()
    emit(out, cell=name, item="warm_s", value=time.perf_counter() - t0)
    windows, merged = [], collections.defaultdict(float)
    for k, (seed, on) in enumerate(((SEEDS[0], False), (SEEDS[0], True),
                                    (SEEDS[1], True), (SEEDS[1], False))):
        timing.TRACE.reset()
        if on:
            timing.enable(device)
        else:
            timing.disable()
        window_s, starts, _, _, peak, readings = cell.measure(seed, seconds)
        timing.disable()
        row = {"cell": name, "item": "window", "k": k, "seed": seed, "recorder": on,
               "round_s": window_s / max(len(starts), 1), "rounds": len(starts),
               "peak_mem_gib": peak / 2**30, "work": readings.work}
        if on:
            summary = timing.TRACE.summary()
            row.update(coverage=coverage(summary), readers=readers(name),
                       spans={n: {"count": s["count"], "host_s": s["total_s"],
                                  "stream_s": s["stream_s"]} for n, s in summary.items()},
                       counters=timing.TRACE.counts())
        windows.append(row)
        emit(out, **row)
    for on in (False, True):
        vals = [w["round_s"] for w in windows if w["recorder"] == on]
        merged["on" if on else "off"] = statistics.mean(vals)
    emit(out, cell=name, item="round_s_on_over_off",
         value=merged["on"] / merged["off"], off=merged["off"], on=merged["on"])
    timing.TRACE.reset()
    timing.enable(device)
    if torch.device(device).type == "cuda":
        for row in sync_sites(cell, SEEDS[0] + 1, cell.traffic["rounds"]):
            emit(out, cell=name, item="sync_sites", **row)
    timing.TRACE.reset()
    timing.disable()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--cells", default="shekel-b100,solvent-b100")
    parser.add_argument("--out", default=str(ROOT / "chiprun_out" / "recorder_cost.jsonl"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("recorder_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    emit(out, item="device", name=torch.cuda.get_device_name(0))
    emit(out, item="host_costs", **host_costs(device))
    for name in args.cells.split(","):
        run_cell(name, args.seconds, device, None, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
