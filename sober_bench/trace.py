"""Reading a torch.profiler stretch of rounds: the device's busy time, the
device time of the work launched inside each benchmark range, the busiest
device operations and the longest idle gaps by what the host was doing.

The stretch is exported as a Chrome trace (a fixed file inside the
checkout, overwritten by each traced run) and read back: kernels, copies
and fills are the device's work; each is tied to the host call that
launched it by its correlation id, and the launch's host time places it in
a range.
"""
from __future__ import annotations

import bisect
import collections
import json
import re
from pathlib import Path

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
ENTRY = re.compile(r"^sober_bench\.entry:(.+)#(\d+)$")
WINDOW = "sober_bench.window"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Stretch:
    """A traced stretch read from its Chrome trace. Times in seconds.

    busy_s: the union of the device's work inside the window range;
    window_s: that range's length; entries[label][i]: the device seconds of
    the work launched inside range `sober_bench.entry:<label>#<i>`;
    device_ops, idle_gaps: the breakdown lists."""

    def __init__(self, path: Path):
        with open(path, encoding="utf-8") as f:
            events = json.load(f)
        events = events.get("traceEvents", events) if isinstance(events, dict) else events
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        window = [e for e in spans if e.get("name") == WINDOW
                  and e.get("cat") in ("user_annotation", "cpu_op")]
        if not window:
            raise RuntimeError("trace: no window range in the profile")
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
        self.window_s = (w1 - w0) / 1e6
        dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
        self.n_device_events = len(dev)
        spans_in = ((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
        merged = _merge((max(s, w0), min(e, w1)) for s, e in spans_in if s < w1 and e > w0)
        self.busy_s = sum(e - s for s, e in merged) / 1e6

        by_name = collections.Counter()
        for e in dev:
            by_name[e["name"]] += float(e["dur"]) / 1e6
        self.device_ops = [[name[:120], secs] for name, secs in by_name.most_common(10)]

        # host ranges: the benchmark's (layers and entries) and the host's ops
        host = [e for e in spans if e.get("cat") in ("user_annotation", "cpu_op")
                or e.get("cat") in LAUNCH_CATS]
        launch_ts = {}
        for e in host:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = float(e["ts"])
        entries = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          m.group(1), int(m.group(2)))
                         for e in host if (m := ENTRY.match(e.get("name", ""))))
        starts = [s for s, *_ in entries]
        self.entries = collections.defaultdict(dict)
        for s, _, label, i in entries:
            self.entries[label][i] = 0.0
        for e in dev:
            t = launch_ts.get(e.get("args", {}).get("correlation"))
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= entries[k][1]:
                _, _, label, i = entries[k]
                self.entries[label][i] += float(e["dur"]) / 1e6

        self.idle_gaps = self._gaps(merged, w0, w1, host)

    @staticmethod
    def _gaps(merged, w0, w1, host):
        """Idle time inside the window by what the host was doing at each
        gap's middle: the innermost benchmark layer and the innermost host
        operation, summed by that pair; the 10 largest."""
        gaps, last = [], w0
        for s, e in merged:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if w1 > last:
            gaps.append((last, w1))
        layers = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                        for e in host if e["name"].startswith("sober_bench.")
                        and not e["name"].startswith("sober_bench.entry")
                        and e["name"] != WINDOW)
        ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in host if not e["name"].startswith("sober_bench."))

        def innermost(ranges, t, lookback):
            """The latest-starting range that holds t, among the `lookback`
            ranges that start last before it."""
            hi = bisect.bisect_right(ranges, (t, float("inf"), ""))
            best = None
            for s, e, name in ranges[max(0, hi - lookback):hi]:
                if s <= t <= e and (best is None or s >= best[0]):
                    best = (s, name)
            return best[1] if best else "none"

        total = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            layer = innermost(layers, mid, len(layers)).removeprefix("sober_bench.")
            total[f"{layer}: {innermost(ops, mid, 400)[:80]}"] += (e - s) / 1e6
        return [[name, secs] for name, secs in total.most_common(10)]
