"""Run one cell: set-up (the configuration's data, one warm episode), a
measured window of BO rounds, then the correctness check against the float64
reference, and the result line.

A round is the body of the examples' loop (loops/<kind>.py): the fit,
Sober.update_model, Sober.next_batch, the batch evaluated and appended,
synced at its end. An episode is one campaign: an initial design drawn from
the campaign's seed, the first fit and a new Sober, then the cell's rounds.
A cell's traffic names a fixed set of campaigns (their count and the seed
they are drawn from); every run takes the same set, in an order drawn from
--seed, cycling, back to back until the window closes. A campaign's work
(refills, resets, the fit's steps) follows from its data, so a set that
changed with --seed would change the work. Episode starts lie in the window
but are not rounds.
"""
from __future__ import annotations

import contextlib
import math
import statistics
import sys
import time

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from sober_bench import probe as pr
from sober_bench import registry

# the warm episode's seed: the same set-up work whatever --seed is
WARM_SEED = 20_260_417
RUNS_DIR = registry.ROOT / ".runs"
FORBIDDEN = ("jax", "jaxlib", "flax", "sober_tpu")
# the traced run's phases, as shares of its window: synced spans, host
# reads, then a profiled stretch with neither
TRACE_PHASES = (("spans", 0.6), ("reads", 0.25), ("profile", 0.15))
MIN_PHASE_ROUNDS = 3


def process_start() -> float:
    """This process's start, seconds since the epoch (Linux /proc)."""
    import os

    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def campaign_seed(base: int, campaign: int) -> int:
    """A 31-bit seed for one campaign of a cell's fixed set."""
    state = np.random.SeedSequence([base, campaign]).generate_state(1)[0]
    return int(state) & 0x7FFF_FFFF


def campaign_order(seed: int, n: int) -> list[int]:
    """The order in which a run takes the cell's campaigns, from --seed:
    every seed runs the same campaigns, in another order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0x0DE5]))
    return [int(c) for c in rng.permutation(n)]


def checked_rounds(seed: int, rounds: int, n: int, answer_episodes: int = 0,
                   answer_rounds: int = 0) -> set:
    """The (episode, round) pairs whose outputs the check compares, drawn
    from the seed: the first episode's last round (the most observations)
    and one more of it, then one round of each next episode, n in all; and
    besides, the first answer_rounds rounds of each of the first
    answer_episodes episodes, where a cell compares its answers only."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0xC0FFEE]))
    pick = {(0, rounds - 1), (0, int(rng.integers(rounds - 1)))}
    e = 1
    while len(pick) < n:
        pick.add((e, int(rng.integers(rounds))))
        e += 1
    return pick | {(e, r) for e in range(answer_episodes) for r in range(answer_rounds)}


def hands_over(k: int, in_phase: int, elapsed: float, seconds: float,
               mean_round: float) -> bool:
    """Whether the traced window's phase k hands over to the next before the
    round that starts `elapsed` seconds into a window of `seconds`. A phase
    keeps at least MIN_PHASE_ROUNDS rounds; after them it hands over once
    its share of the window has passed, or once the time left would not
    give every later phase its MIN_PHASE_ROUNDS rounds at the window's mean
    round so far (episode starts and refill storms included)."""
    later = len(TRACE_PHASES) - 1 - k
    if later == 0 or in_phase < MIN_PHASE_ROUNDS:
        return False
    share_end = seconds * sum(share for _, share in TRACE_PHASES[:k + 1])
    return elapsed >= share_end or seconds - elapsed < later * MIN_PHASE_ROUNDS * mean_round


def stretch_device(stretch) -> dict | None:
    """The traced line's busy_s and window_s, from the profiled stretch;
    None where there is no stretch or no device work in it."""
    if stretch is None or stretch.n_device_events == 0 or not stretch.busy_s > 0:
        return None
    return {"busy_s": stretch.busy_s, "window_s": stretch.window_s}


def stretch_calls(entries: dict) -> dict:
    """The profiled stretch's calls of each public entry, counted by the
    whole-number sizes of their shape (car: {"m=400,q=200": 36})."""
    out = {}
    for label, calls in entries.items():
        tally = out.setdefault(label, {})
        for shape, _ in calls:
            key = ",".join(f"{k}={v}" for k, v in shape.items() if isinstance(v, int))
            tally[key] = tally.get(key, 0) + 1
    return out


@contextlib.contextmanager
def reference_precision():
    """float32 matmuls without TF32 inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class Readings:
    """What a traced run gives the per-layer readers: spans[name] (seconds a
    call, in the order of the rounds), span_rounds[name] (the window's round
    of each of those calls), reads (host reads a next_batch),
    entries[label] (each call's shape dict and device seconds), stretch
    (trace.Stretch of the profiled rounds), e2e (the window's end-to-end
    numbers, as end_to_end gives them). `work` tallies each episode of
    the window, traced or not: its campaign, rounds, optimiser steps (the
    fits', the first fit's included), the sampler's host reads (one a refill
    round, and one a draw's health check) and proposal resets. `phases`
    gives the rounds each phase of the window had, and `overrun_s` how far
    past its deadline the window closed."""

    def __init__(self):
        self.spans, self.span_rounds, self.reads = {}, {}, []
        self.entries, self.stretch, self.work = {}, None, []
        self.e2e, self.phases, self.overrun_s = {}, {}, 0.0


class Cell:
    def __init__(self, name: str, device="cuda", traffic=None):
        """`traffic` overrides the cell's own (tests run cells smaller)."""
        self.name = name
        self.workload = registry.workload(name)
        self.traffic = dict(self.workload["traffic"], **(traffic or {}))
        self.limits = self.workload["limits"]
        self.config = registry.config(self.workload["config"])
        self.device = torch.device(device)
        self.loop = registry.loop(self.config["loop"]).Loop(
            self.config, self.traffic, self.device, registry.config_module(self.config))
        self.probe = pr.Probe(self.sync)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def round(self, ep, reads=None):
        loop, p = self.loop, self.probe
        with p.span(loop.fit_span):
            model = loop.fit(ep)
        with p.span("update_model"):
            loop.update(ep, model, p)
        with p.span(pr.NEXT_BATCH):
            if reads is None:
                out = loop.next_batch(ep)
            else:
                with pr.host_reads(reads):
                    out = loop.next_batch(ep)
        if p.record is not None:
            loop.keep(ep, model, out, p.record)
        with p.span("observe"):
            loop.observe(ep, out)
        self.sync()

    def warm(self):
        """One whole episode at the cell's shapes, so that every kernel is
        built and every shape of the window has run once."""
        ep = self.loop.start(WARM_SEED, self.probe)
        for _ in range(self.traffic["rounds"]):
            self.round(ep)
        del ep
        self.sync()

    def measure(self, seed: int, seconds: float, entries=None):
        """The window. Without `entries` (a dict for probe.EntryRanges) the
        plain run, which closes at its first round start past the deadline;
        with it, the traced run's three phases (hands_over), which closes
        there too once the profiled stretch has had MIN_PHASE_ROUNDS rounds,
        and runs on by whole rounds until then. Returns (window seconds,
        round start times and the window's end by time.perf_counter,
        records, peak bytes, Readings)."""
        rounds, spec = self.traffic["rounds"], self.workload["check"]
        # the rounds whose answers (pi, weights, moments) a cell compares:
        # every round, or its episodes' first few (PERF.md section 4)
        answer_rounds = spec.get("answer_rounds", rounds)
        check = checked_rounds(seed, rounds, spec["rounds"], spec.get("answer_episodes", 0),
                               answer_rounds)
        order = campaign_order(seed, self.traffic["campaigns"])
        traced = entries is not None
        phases = TRACE_PHASES if traced else (("plain", 1.0),)
        readings = Readings()
        records, starts, phase, prof, ranges = [], [], None, None, None
        k, in_phase = 0, 0
        p = self.probe

        def closes(now):
            return now >= deadline and (not traced or (
                k == len(phases) - 1 and in_phase >= MIN_PHASE_ROUNDS))

        steps = [0]
        hook = register_optimizer_step_post_hook(
            lambda *_: steps.__setitem__(0, steps[0] + 1))
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        deadline, episode, stop = t0 + seconds, 0, False
        while not stop:
            campaign = order[episode % len(order)]
            steps[0] = 0
            with p.span("episode_start"):
                ep = self.loop.start(campaign_seed(self.traffic["campaign_seed"], campaign), p)
            tally = {"campaign": campaign, "rounds": 0, "fit_steps": 0, "sampler_reads": 0}
            readings.work.append(tally)
            for r in range(rounds):
                now = time.perf_counter()
                if closes(now):
                    stop = True
                    break
                if traced and hands_over(k, in_phase, now - t0, seconds,
                                         (now - t0) / max(len(starts), 1)):
                    k, in_phase = k + 1, 0
                in_phase += 1
                readings.phases[phases[k][0]] = in_phase
                if phases[k][0] != phase:
                    phase = phases[k][0]
                    p.spans = readings.spans if phase == "spans" else None
                    p.span_rounds = readings.span_rounds
                    if phase == "profile":
                        prof, ranges = self._start_profile(entries)
                        p.annotate = True
                p.record = ({"answers": r < answer_rounds, "at": [episode, r]}
                            if (episode, r) in check else None)
                p.round = len(starts)
                starts.append(now)
                self.round(ep, readings.reads if phase == "reads" else None)
                if p.record is not None:
                    records.append(p.record)
                tally["rounds"] += 1
                tally["sampler_reads"] += getattr(ep.sober, "last_reads", 0)
            tally["fit_steps"] = steps[0]
            tally["resets"] = getattr(ep.sober, "reset_count", 0)
            episode += 1
            stop = stop or closes(time.perf_counter())
        t_stop = time.perf_counter()
        readings.overrun_s = t_stop - deadline
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        hook.remove()
        p.spans, p.record, p.annotate = None, None, False
        if prof is not None:
            readings.stretch, readings.entries = self._end_profile(prof, ranges)
        del ep
        return t_stop - t0, starts, t_stop, records, peak, readings

    def _start_profile(self, entries):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        ranges = pr.EntryRanges(entries)
        ranges.__enter__()
        window = torch.profiler.record_function("sober_bench.window")
        window.__enter__()
        return prof, (ranges, window)

    def _end_profile(self, prof, ranges):
        from sober_bench.trace import Stretch

        entry_ranges, window = ranges
        self.sync()
        window.__exit__(None, None, None)
        entry_ranges.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        RUNS_DIR.mkdir(parents=True, exist_ok=True)
        path = RUNS_DIR / f"{self.name}.trace.json"
        prof.export_chrome_trace(str(path))
        stretch = Stretch(path)
        entries = {label: [(calls[i], stretch.entries.get(label, {}).get(i, 0.0))
                           for i in range(len(calls))]
                   for label, calls in entry_ranges.calls.items()}
        return stretch, entries

    def judge(self, records) -> tuple[bool, dict, int]:
        """Each compared number, the widest over the checked rounds, beside
        its limit; correct when every one is within its limit and at least
        one round was checked. The reference runs with TF32 off whatever
        the process set. Returns (correct, {name: [value, limit]}, rounds
        that failed); each checked round's numbers stay in last_rounds."""
        widest, failed = {}, 0
        self.last_rounds = []
        for rec in records:
            with reference_precision():
                nums = self.loop.judge(rec)
            self.last_rounds.append(dict(nums, at=rec.get("at")))
            failed += any(nums[k] > lim for k, lim in self.limits.items() if k in nums)
            for k, v in nums.items():
                widest[k] = max(widest.get(k, -math.inf), v)
        checks = {k: [widest.get(k, math.inf), lim] for k, lim in self.limits.items()}
        correct = bool(records) and all(v <= lim for v, lim in checks.values())
        # numbers without a limit are printed for the record
        for k, v in widest.items():
            checks.setdefault(k, [v, None])
        return correct, checks, failed


def end_to_end(window_s: float, starts: list, t_stop: float, peak: int,
               setup_s: float) -> dict:
    """round_s over the whole window; round_p90_s over every round, each
    from its start to the next round's start (the last to the window's
    end); the window's peak memory; the set-up time."""
    durations = [b - a for a, b in zip(starts, starts[1:] + [t_stop])]
    p90 = (statistics.quantiles(durations, n=10, method="inclusive")[-1]
           if len(durations) >= 2 else sum(durations))
    return {"round_s": window_s / max(len(starts), 1), "round_p90_s": p90,
            "peak_mem_gib": peak / 2**30, "setup_s": setup_s}


def run(name: str, seed: int, seconds: float, trace: bool, t_process: float) -> tuple[dict, int]:
    """One run of a cell on the card, as the benchmark's command makes it.
    Returns (the result line's object, exit code)."""
    bench = registry.benchmark()
    cell = Cell(name, "cuda")
    cell.warm()
    layer = registry.per_layer_for(name, bench) if trace else []
    modules = {m["name"]: registry.metric(m["name"]) for m in layer}
    entries = {mod.ENTRY[0]: mod.ENTRY[1:] for mod in modules.values()
               if hasattr(mod, "ENTRY")}
    setup_s = time.time() - t_process
    window_s, starts, t_stop, records, peak, readings = cell.measure(
        seed, seconds, entries if trace else None)
    bad = forbidden_modules()
    if bad:
        print(f"sober_bench: modules {bad} were loaded; the benchmark runs the "
              "port without jax or the JAX package", file=sys.stderr)
        return {}, 3
    stretch = stretch_device(readings.stretch) if trace else None
    if trace and stretch is None:
        print(f"sober_bench: the traced window's profiled stretch holds no device work "
              f"(rounds a phase {readings.phases}, {readings.overrun_s:.3f} s past the "
              "deadline); no result", file=sys.stderr)
        return {}, 4
    e2e = end_to_end(window_s, starts, t_stop, peak, setup_s)
    readings.e2e = e2e
    torch.cuda.empty_cache()
    correct, checks, failed = cell.judge(records)
    metrics = {}
    if trace:
        for m in layer:
            value = modules[m["name"]].read(readings)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.end_to_end_for(name, bench):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(starts), "failed": failed,
           "metrics": metrics, "device": device}
    if trace:
        device.update(stretch)
        out["breakdown"] = {"device_ops": readings.stretch.device_ops,
                            "idle_gaps": readings.stretch.idle_gaps}
        # how the traced window went: the rounds each phase had, how far it
        # ran past its deadline, and the entries' calls in its stretch
        out.update(phases=readings.phases, overrun_s=readings.overrun_s,
                   stretch_calls=stretch_calls(readings.entries))
    # what the window did, episode by episode: two runs of one seed do the
    # same work in the rounds that both reach
    out["work"] = readings.work
    # a number no checked round gave is printed as null (and is not correct)
    out["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                     for k, (v, lim) in checks.items() if lim is not None}
    return out, 0
