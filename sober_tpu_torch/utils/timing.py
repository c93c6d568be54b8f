"""The port's one recorder: named spans and counters at each layer boundary of
sober_tpu_torch, and optional torch.profiler traces (port of
sober_tpu/utils/timing.py).

`TRACE` is the process-wide `Tracer` that the program records into. It is
off by default: `span()` then returns one shared no-op context and
`count()` returns at once, with no clock, event, lock or allocation (under
1 us a call on the host). `enable()` switches it on and `disable()` off
again; both may be called any number of times.

On, each span records its name, its parent, the id of the top-level call
it belongs to (the span opened with no other open: `fit`, `next_batch`,
`step`, `update_model`, ...), and its host start and end
(`time.perf_counter_ns`). On a CUDA device it also records a pair of
`torch.cuda.Event`s, drawn from a reusable pool, on the current stream:
the stream's time from the span's start marker to its end marker, with no
added sync. Many stages end without a host read, so their host span times
only the launch; their stream time is the work. Events are resolved lazily
(`Event.query`) when a top-level call ends, and all remaining ones at
`summary()` or `calls()`, after one synchronize. Spans are summed by name
within their call as they resolve, and the latest CALLS_KEPT calls are
kept, so memory stays bounded over a long run; `summary()` sums the calls
kept.
While torch.profiler runs, each span also opens a `record_function`
range named `sober.<name>`, on the trace's clock beside the kernels, and
is marked `profiled`, so that readers can leave the profiler's cost out.
A span opened directly inside an open span of the same name is merged
into it. The recorder follows the one host thread the port runs on.

`timed()` spans always time the host clock (the program reads them back:
`Sober.last_timings`), and record only when the recorder is on, or with
`keep=True` (once-a-process set-up, such as `setup.library`) whatever the
switch says: those go to one record of the process that is never dropped.

Counters: `count(name, n)` adds to the open call's counts (the process
record's outside any call). `host_reads.<site>` counts each deliberate
device-to-host read where it is made.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Optional

import torch

from ..config import resolve_device

# the spans the program records
PHASES = (
    "setup.library",
    "fit", "fit.loss", "fit.grad", "fit.update", "fit.state",
    "update_model", "next_batch", "step", "step_fbgp",
    "next_batch.candidates", "next_batch.dataset", "next_batch.polish",
    "sampler.draw", "sampler.pdf", "sampler.pi", "sampler.update_prior",
    "sampler.refill", "sampler.nystrom", "sampler.prune",
    "recombination", "recombination.basis", "recombination.round",
    "recombination.final",
)
# host seconds kept per name in Tracer.records, and calls kept for their sums
RECORDS_KEPT = 4096
CALLS_KEPT = 4096


_profiling = torch._C._autograd._profiler_enabled


class _Noop:
    """The span of a recorder that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Span:
    """One span of a Tracer; `seconds` holds its host duration once it has
    ended. `record` False: it times the host clock and records nothing;
    `kept`: it records into the tracer's process record."""

    __slots__ = ("tracer", "name", "block", "record", "kept", "seconds", "parent",
                 "call", "profiled", "t0", "events", "child_s", "child_stream_s",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, block, record: bool,
                 kept: bool = False):
        self.tracer, self.name, self.block, self.record = tracer, name, block, record
        self.kept = kept
        self.seconds = None

    def __enter__(self):
        if self.record:
            self.tracer._open(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        if self.block:
            tr._wait(self.block)
        self.seconds = (time.perf_counter_ns() - self.t0) * 1e-9
        if self.record:
            tr._close(self)
        return False


class Tracer:
    """Spans and counters (see the module's docstring). `device`: the device
    a blocking span waits for (CUDA unless given); `profile_dir`: where
    start_profile / stop_profile write a Chrome trace; `enabled`: whether
    span() records (a Tracer you make records; the program's TRACE starts
    off). `records[name]` keeps the host seconds of the latest
    RECORDS_KEPT spans of each name. A call is a dict: id, name, profiled
    (its top-level span opened under the profiler), spans {name: [count,
    host s, host self s, stream s, stream self s, spans with a stream time,
    max host s]} and counts {name: n}."""

    def __init__(self, profile_dir: Optional[str] = None, device=None,
                 enabled: bool = True):
        self.records: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=RECORDS_KEPT))
        self.profile_dir = profile_dir
        self.device = resolve_device(device)
        self.enabled = enabled
        # whether spans mark the stream: decided at the first span, so that
        # making a Tracer asks nothing of CUDA
        self._stream = None
        # the stream a call's spans mark, fetched once a call
        self._cur = None
        self._profiler = None
        self._stack: list[Span] = []
        self._calls = collections.deque(maxlen=CALLS_KEPT)
        self._next_call = 0
        # kept spans, and counts made outside any call
        self._process = self._new_call(-1, None, False)
        self._pending = collections.deque()
        self._pool: list = []

    # -- recording -------------------------------------------------------------

    def span(self, phase: str, block=False):
        """A span named `phase`; the shared no-op when the tracer is off or
        when the innermost open span has the same name. `block`: wait for
        the device (True: the tracer's; or a torch.device) before the
        clock stops, so the span covers the work queued inside it."""
        if not self.enabled or (self._stack and self._stack[-1].name == phase):
            return NOOP
        return Span(self, phase, block, True)

    def timed(self, phase: str, block=False, keep: bool = False) -> Span:
        """A span that always times the host clock (its `seconds`), and
        records when the tracer is on, or with `keep` whatever it says."""
        return Span(self, phase, block, self.enabled or keep, keep)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name` in the open call (the process record's
        outside any call)."""
        if not self.enabled:
            return
        counts = (self._stack[-1].call if self._stack else self._process)["counts"]
        counts[name] = counts.get(name, 0) + n

    @staticmethod
    def _new_call(call_id: int, name, profiled: bool) -> dict:
        return {"id": call_id, "name": name, "profiled": profiled, "spans": {},
                "counts": {}}

    def _wait(self, block) -> None:
        dev = block if isinstance(block, torch.device) else self.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _open(self, s: Span) -> None:
        stack = self._stack
        s.profiled = _profiling()
        s.parent = stack[-1] if stack else None
        if s.kept:
            s.call = self._process
        elif s.parent is not None:
            s.call = s.parent.call
        else:
            s.call = self._new_call(self._next_call, s.name, s.profiled)
            self._next_call += 1
            self._calls.append(s.call)
        s.child_s = s.child_stream_s = 0.0
        s._range = None
        if s.profiled:
            s._range = torch.profiler.record_function("sober." + s.name)
            s._range.__enter__()
        s.events = None
        if self._stream is None:
            self._stream = self.device.type == "cuda" and torch.cuda.is_available()
        if self._stream and self.enabled:
            if s.parent is None:
                self._cur = torch.cuda.current_stream()
            s.events = self._pool.pop() if self._pool else (
                torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            s.events[0].record(self._cur)
        stack.append(s)

    def _close(self, s: Span) -> None:
        if s.events is not None:
            s.events[1].record(self._cur)
        if s._range is not None:
            s._range.__exit__(None, None, None)
        self._stack.pop()
        if s.parent is not None:
            s.parent.child_s += s.seconds
        self.records[s.name].append(s.seconds)
        per = s.call["spans"].get(s.name)
        if per is None:
            per = s.call["spans"][s.name] = [0, 0.0, 0.0, 0.0, 0.0, 0, 0.0]
        per[0] += 1
        per[1] += s.seconds
        per[2] += s.seconds - s.child_s
        per[6] = max(per[6], s.seconds)
        if s.events is not None:
            self._pending.append(s)
        if not self._stack:
            self._poll()

    def _resolve_one(self, s: Span) -> None:
        start, end = s.events
        s.events = None
        try:
            stream_s = start.elapsed_time(end) * 1e-3
        except RuntimeError:
            # two markers on different devices have no common clock
            stream_s = None
        self._pool.append((start, end))
        if stream_s is None:
            return
        if s.parent is not None:
            s.parent.child_stream_s += stream_s
        per = s.call["spans"][s.name]
        per[3] += stream_s
        per[4] += stream_s - s.child_stream_s
        per[5] += 1

    def _poll(self) -> None:
        """Resolve the spans whose end markers the stream has passed, oldest
        first (a span's children end before it)."""
        pending = self._pending
        while pending and pending[0].events[1].query():
            self._resolve_one(pending.popleft())

    def resolve(self) -> None:
        """Wait for the device once, then resolve every pending span."""
        if self._pending:
            torch.cuda.synchronize()
            while self._pending:
                self._resolve_one(self._pending.popleft())

    def reset(self) -> None:
        """Forget every span, counter and call recorded so far."""
        self.resolve()
        self.records.clear()
        self._calls.clear()
        self._process = self._new_call(-1, None, False)

    # -- reading -------------------------------------------------------------

    def summary(self) -> dict[str, dict]:
        """Per name, over the calls kept and the kept spans: count, host
        seconds (total_s, mean_s, max_s, self_s), and the stream's
        (stream_s, stream_self_s; None without a stream clock)."""
        out = {}
        for c in self.calls() + [self._process]:
            for name, per in c["spans"].items():
                row = out.get(name)
                if row is None:
                    out[name] = list(per)
                    continue
                for i in range(6):
                    row[i] += per[i]
                row[6] = max(row[6], per[6])
        return {name: {"count": r[0], "total_s": r[1], "mean_s": r[1] / r[0],
                       "max_s": r[6], "self_s": r[2],
                       "stream_s": r[3] if r[5] else None,
                       "stream_self_s": r[4] if r[5] else None}
                for name, r in out.items()}

    def counts(self) -> dict[str, int]:
        """Each counter's total over the calls kept and outside any call."""
        out: dict[str, int] = {}
        for c in self.calls() + [self._process]:
            for name, n in c["counts"].items():
                out[name] = out.get(name, 0) + n
        return out

    def calls(self, name: Optional[str] = None) -> list:
        """The calls kept, oldest first, whose top-level span is `name` (any
        when None); each a dict as the class's docstring says."""
        self.resolve()
        return [c for c in self._calls if name is None or c["name"] == name]

    def per_call(self, top: str, span: Optional[str] = None,
                 prefix: Optional[str] = None) -> Optional[float]:
        """The mean over the calls of `top` opened outside the profiler (so
        that its cost is left out) of, in each call: the seconds of the
        spans named `span` (the stream's, or the host's without a stream
        clock); or the counters named `prefix` or starting with `prefix` +
        "."; None without such a call."""
        calls = [c for c in self.calls(top) if not c["profiled"]]
        if not calls:
            return None
        total = 0.0
        for c in calls:
            if span is not None:
                per = c["spans"].get(span)
                if per is not None:
                    total += per[3] if per[5] else per[1]
            else:
                total += sum(n for k, n in c["counts"].items()
                             if k == prefix or k.startswith(prefix + "."))
        return total / len(calls)

    def report(self) -> str:
        lines = [f"{'phase':<24}{'count':>7}{'total [s]':>12}{'mean [s]':>12}"
                 f"{'stream [s]':>12}"]
        for phase, s in sorted(self.summary().items()):
            stream = "" if s["stream_s"] is None else f"{s['stream_s']:>12.4f}"
            lines.append(f"{phase:<24}{s['count']:>7}{s['total_s']:>12.4f}"
                         f"{s['mean_s']:>12.4f}{stream}")
        return "\n".join(lines)

    # -- torch.profiler --------------------------------------------------------

    def start_profile(self):
        if self.profile_dir and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()

    def stop_profile(self) -> Optional[str]:
        """Stops the trace and writes it to profile_dir/trace.json; returns
        the path. The program's spans are in it as `sober.<name>` ranges."""
        if self._profiler is None:
            return None
        self._profiler.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        return path


# the program's recorder, off until enable()
TRACE = Tracer(enabled=False)


def enable(device=None) -> None:
    """Switch the program's recorder on; `device`: the one whose stream its
    spans mark (CUDA unless given; no stream clock without a card)."""
    TRACE.device = resolve_device(device)
    TRACE._stream = None
    TRACE.enabled = True


def disable() -> None:
    TRACE.enabled = False


def span(name: str, block=False):
    return TRACE.span(name, block)


def timed(name: str, block=False, keep: bool = False) -> Span:
    return TRACE.timed(name, block, keep)


def count(name: str, n: int = 1) -> None:
    if TRACE.enabled:
        TRACE.count(name, n)

