"""What the prog.* readers share: the program's own recorder (TRACE in
sober_tpu_torch/utils/timing.py), switched on when this file is first
imported. The harness imports per-layer readers only for --trace 1, after
the warm episode, so the plain runs never switch it on and the traced
window is recorded whole. Readers take means per call of the program's
top-level span (a fit, a Sober.next_batch) over the calls opened outside
the profiled stretch, so the profiler's cost is left out. On a program
without the recorder, every reader gives nothing."""
try:
    from sober_tpu_torch.utils import timing

    timing.enable()
    TRACE = timing.TRACE
except (ImportError, AttributeError):
    TRACE = None


def reader(top: str, span: str | None = None, counters: str | None = None,
           scale: float = 1.0):
    """read(r): the mean per call of `top` of the seconds of the spans named
    `span` in it (the stream's on the card), times `scale`; or of the
    counters named `counters` or starting with it and a dot."""

    def read(_r):
        if TRACE is None or not hasattr(TRACE, "per_call"):
            return None
        value = TRACE.per_call(top, span=span, prefix=counters)
        return None if value is None else scale * value

    return read


def setup_s(name: str):
    """read(r): the host seconds of the once-a-process span `name`."""

    def read(_r):
        if TRACE is None or not hasattr(TRACE, "per_call"):
            return None
        row = TRACE.summary().get(name)
        return None if row is None else row["total_s"]

    return read
