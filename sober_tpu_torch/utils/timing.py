"""Structured per-phase timing and optional torch.profiler traces (port of
sober_tpu/utils/timing.py).

The phase names are the reference's (pi-sampling, prior update, Nystrom,
recombination, GP fit), kept as structured records. A blocking span waits
for the device before it stops its clock, so it covers the work queued
inside it, not only its launch.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Optional

import torch

from ..config import resolve_device

PHASES = ("gp_fit", "pi_sampling", "prior_update", "nystrom",
          "recombination", "objective_eval")


class Tracer:
    """Collects (phase -> list of durations, s) with nesting-safe spans.
    `device`: the device a blocking span waits for (CUDA unless given);
    `profile_dir`: where start_profile / stop_profile write a Chrome
    trace."""

    def __init__(self, profile_dir: Optional[str] = None, device=None):
        self.records: dict[str, list[float]] = defaultdict(list)
        self.profile_dir = profile_dir
        self.device = resolve_device(device)
        self._profiler = None

    @contextlib.contextmanager
    def span(self, phase: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.records[phase].append(time.perf_counter() - t0)

    def start_profile(self):
        if self.profile_dir and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()

    def stop_profile(self) -> Optional[str]:
        """Stops the trace and writes it to profile_dir/trace.json; returns
        the path."""
        if self._profiler is None:
            return None
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        return path

    def summary(self) -> dict[str, dict[str, float]]:
        return {phase: {"count": len(times), "total_s": sum(times),
                        "mean_s": sum(times) / len(times), "max_s": max(times)}
                for phase, times in self.records.items()}

    def report(self) -> str:
        lines = [f"{'phase':<16}{'count':>6}{'total [s]':>12}{'mean [s]':>12}"]
        for phase, s in sorted(self.summary().items()):
            lines.append(f"{phase:<16}{s['count']:>6}{s['total_s']:>12.4f}"
                         f"{s['mean_s']:>12.4f}")
        return "\n".join(lines)
