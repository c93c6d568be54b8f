"""The benchmark's own instruments, placed around calls into the program from
outside: synced spans, the host-read counter, the recorders that keep what
the correctness check compares, and profiler ranges around public entries.

Nothing here changes what the program computes; a wrapper calls the
wrapped callable once with the same arguments and returns its result.
"""
from __future__ import annotations

import contextlib
import functools
import sys
import time
import warnings

import torch

# span names that per-layer readers look up
NEXT_BATCH, RECOMBINATION = "next_batch", "recombination"


class Probe:
    """What the instruments do in the current round. `spans`: a dict of
    span name -> [seconds] to append synced spans to, or None; beside each,
    span_rounds[name] gets `round`, the window's round. `record`: a
    dict to keep the round's check inputs in, or None. `annotate`: open
    torch.profiler ranges (no syncs)."""

    def __init__(self, sync=torch.cuda.synchronize):
        self.sync = sync
        self.spans = None
        self.span_rounds = {}
        self.round = 0
        self.record = None
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        """A synced span (spans phase) or a profiler range (profile phase)
        around the block."""
        if self.spans is not None:
            self.sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.spans.setdefault(name, []).append(time.perf_counter() - t0)
                self.span_rounds.setdefault(name, []).append(self.round)
        elif self.annotate:
            with torch.profiler.record_function(f"sober_bench.{name}"):
                yield
        else:
            yield


@contextlib.contextmanager
def host_reads(out: list):
    """Counts the synchronizing device-to-host operations inside the block,
    with torch.cuda's sync debug mode; appends the count to `out`. Without
    a CUDA device there is nothing to count, and nothing is appended."""
    if not torch.cuda.is_available():
        yield
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out.append(sum("synchronizing" in str(w.message) for w in caught))


class PiRecorder:
    """Stands in for a Sober's pi: keeps (x, pi(x)) of its first `keep`
    calls in `calls` (a round's first draw and the pool it hands on, where
    no refill replaced rows) and forwards everything else to it."""

    def __init__(self, pi, calls: list, keep: int = 2):
        self._pi, self._calls, self._keep = pi, calls, keep

    def __call__(self, x, *args, **kwargs):
        out = self._pi(x, *args, **kwargs)
        if len(self._calls) < self._keep:
            self._calls.append((x, out))
        return out

    def __getattr__(self, name):
        return getattr(self._pi, name)


def watch_recombination(sober, probe: Probe) -> None:
    """Wraps sober.sampling_recombination: a synced span of it in the spans
    phase, a profiler range in the profile phase, and its inputs and outputs
    kept when the round is recorded."""
    inner = sober.sampling_recombination

    def run(x_cand, x_nys, weights, batch_size, calc_obj=None):
        with probe.span(RECOMBINATION):
            idx, w = inner(x_cand, x_nys, weights, batch_size, calc_obj=calc_obj)
        if probe.record is not None:
            probe.record["recombination"] = dict(x_cand=x_cand, x_nys=x_nys,
                                                 weights=weights, idx=idx, w=w)
        return idx, w

    sober.sampling_recombination = run


def watch_pi(sober, probe: Probe) -> None:
    """In a recorded round, stand a PiRecorder in for the Sober's current pi
    (update_model makes a new pi each round)."""
    if probe.record is not None:
        sober.pi = PiRecorder(sober.pi, probe.record.setdefault("pi_calls", []))


class EntryRanges:
    """Profiler ranges around public entry points of the program, wherever
    a module of the program binds them: each call runs inside a range named
    ``sober_bench.entry:<label>#<i>``, and calls[label][i] keeps
    `shape(args, kwargs, out)`. The device time of all the work launched in
    a range is the entry's, whatever kernel or library implements it."""

    def __init__(self, entries: dict):
        # label -> (module name, function name, shape function)
        self.entries = entries
        self.calls = {label: [] for label in entries}
        self._saved = []

    def __enter__(self):
        import importlib

        for label, (mod_name, fn_name, shape) in self.entries.items():
            fn = getattr(importlib.import_module(mod_name), fn_name)
            calls = self.calls[label]

            @functools.wraps(fn)
            def ranged(*args, __fn=fn, __label=label, __shape=shape, __calls=calls,
                       **kwargs):
                with torch.profiler.record_function(
                        f"sober_bench.entry:{__label}#{len(__calls)}"):
                    out = __fn(*args, **kwargs)
                __calls.append(__shape(args, kwargs, out))
                return out

            for mod in list(sys.modules.values()):
                name = getattr(mod, "__name__", "") or ""
                if name.split(".")[0] != "sober_tpu_torch":
                    continue
                for attr, val in list(vars(mod).items()):
                    if val is fn:
                        self._saved.append((mod, attr, fn))
                        setattr(mod, attr, ranged)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            # a counter the program keeps on its function, counted on the
            # wrapper while it stood there, goes back to the function
            wrapper = getattr(mod, attr)
            for key, val in vars(wrapper).items():
                if key in vars(fn) and isinstance(val, int) and key != "__wrapped__":
                    setattr(fn, key, val)
            setattr(mod, attr, fn)
        self._saved.clear()
        return False
