"""The prog.* readers: each reads the program's own recorder
(sober_tpu_torch/utils/timing.py), here filled by hand on a clock moved by
hand, as a mean per call outside the profiler; importing one switches the
recorder on; each cell gets the readers that BENCHMARK.json lists for it."""
import subprocess
import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)
from sober_bench import harness, registry  # noqa: E402
from sober_tpu_torch.utils import timing  # noqa: E402

SHEKEL = {"prog.fit_ms.exact", "prog.fit_steps.exact", "prog.fit_host_reads.exact",
          "prog.next_batch_ms", "prog.candidates_ms", "prog.recombination_ms",
          "prog.next_batch_host_reads", "prog.refill_rounds", "prog.pdf_ms", "prog.pi_ms",
          "prog.update_prior_ms", "prog.nystrom_ms", "prog.library_s",
          "prog.cholesky_retries.exact", "prog.resets", "prog.n_pos"}
SOLVENT = {"prog.fit_ms.tanimoto", "prog.fit_evals.tanimoto", "prog.fit_host_reads.tanimoto",
           "prog.next_batch_ms.screen", "prog.candidates_ms.screen",
           "prog.recombination_ms.screen", "prog.next_batch_host_reads.screen",
           "prog.pi_ms.screen", "prog.library_s", "prog.adam_fallbacks.tanimoto"}


def _program():
    """The readers' shared module; its first import switches this process's
    recorder on, which the other tests here do not want."""
    prog = registry.metric("_program")
    timing.disable()
    return prog


class Clock:
    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def step(self, ms):
        self.ns += int(ms * 1e6)


def _leaf(name, clock, ms, **counts):
    with timing.span(name):
        for k, n in counts.items():
            timing.count(k.replace("__", "."), n)
        clock.step(ms)


def _next_batch(clock, refills, resets, n_pos):
    """A next_batch of 20 ms: candidates 12 (draws with their pdf and pi,
    the update, refills ending with n_pos positive rows, Nystrom) and
    recombination 6."""
    with timing.span("next_batch"):
        timing.count("host_reads._targets", 2)
        timing.count("sampler.resets", resets)
        clock.step(1)
        with timing.span("next_batch.candidates"):
            for _ in range(2):
                with timing.span("sampler.draw"):
                    _leaf("sampler.pdf", clock, 2)
                    _leaf("sampler.pi", clock, 1)
            _leaf("sampler.update_prior", clock, 1, host_reads__jitter_cholesky=4)
            for _ in range(refills):
                _leaf("sampler.refill", clock, 0.5, sampler__refill_rounds=1,
                      host_reads__refill=1)
            timing.count("sampler.n_pos", n_pos)
            clock.step(3 - 0.5 * refills)
            _leaf("sampler.nystrom", clock, 2)
        with timing.span("recombination"):
            _leaf("recombination.basis", clock, 2, host_reads__nystrom_basis=1)
            _leaf("recombination.round", clock, 4, host_reads__null_basis=3)
        clock.step(1)


def _fit(clock, steps, retries, fallbacks):
    with timing.span("fit"):
        timing.count("fit.cholesky_retries", retries)
        timing.count("fit.adam_fallbacks", fallbacks)
        for _ in range(steps):
            timing.count("fit.steps")
            _leaf("fit.loss", clock, 1, fit__evals=1, host_reads__loss=1,
                  host_reads__cholesky=2)
            _leaf("fit.grad", clock, 2)
            _leaf("fit.update", clock, 1)
        _leaf("fit.state", clock, 2, host_reads__jitter_cholesky=2)


@pytest.fixture
def filled(monkeypatch):
    """Two fits (3 and 5 steps), two next_batch calls (0 and 2 refill
    rounds), the library's load, and one next_batch under the profiler."""
    prog = _program()
    tr = timing.Tracer(device="cpu", enabled=False)
    clock = Clock()
    monkeypatch.setattr(timing, "TRACE", tr)
    monkeypatch.setattr(timing, "time", clock)
    monkeypatch.setattr(prog, "TRACE", tr)
    with timing.timed("setup.library", keep=True):
        clock.step(1500)
    tr.enabled = True
    _fit(clock, 3, retries=1, fallbacks=0)
    _fit(clock, 5, retries=3, fallbacks=1)
    _next_batch(clock, 0, resets=1, n_pos=300)
    _next_batch(clock, 2, resets=0, n_pos=500)
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    _next_batch(clock, 4, resets=1, n_pos=900)
    return tr


EXPECTED = {
    # fits of 3 and 5 steps of 4 ms, and a state of 2 ms
    "prog.fit_ms.exact": 18.0, "prog.fit_ms.tanimoto": 18.0,
    "prog.fit_steps.exact": 4.0, "prog.fit_evals.tanimoto": 4.0,
    # 3 reads a step, 2 in the state
    "prog.fit_host_reads.exact": 14.0, "prog.fit_host_reads.tanimoto": 14.0,
    "prog.next_batch_ms": 20.0, "prog.candidates_ms": 12.0, "prog.recombination_ms": 6.0,
    "prog.next_batch_host_reads": 11.0,                          # 10, and 12 with 2 refills
    "prog.refill_rounds": 1.0, "prog.pdf_ms": 4.0, "prog.pi_ms": 2.0,
    "prog.update_prior_ms": 1.0, "prog.nystrom_ms": 2.0, "prog.library_s": 1.5,
    "prog.cholesky_retries.exact": 2.0, "prog.adam_fallbacks.tanimoto": 0.5,
    "prog.resets": 0.5, "prog.n_pos": 400.0,
}


@pytest.mark.parametrize("name", sorted(SHEKEL | SOLVENT))
def test_each_reader_reads_the_recorder_per_call(filled, name):
    base = name.removesuffix(".screen")
    value = registry.metric(name).read(harness.Readings())
    assert value == pytest.approx(EXPECTED[base])


def test_without_the_recorder_a_reader_gives_nothing(monkeypatch):
    monkeypatch.setattr(_program(), "TRACE", None)
    assert all(registry.metric(n).read(harness.Readings()) is None
               for n in SHEKEL | SOLVENT)


def test_each_cell_gets_the_readers_of_the_table():
    for cell, names in (("shekel-b100", SHEKEL), ("solvent-b100", SOLVENT)):
        got = {m["name"] for m in registry.per_layer_for(cell) if m["name"].startswith("prog.")}
        assert got == names


PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
from sober_tpu_torch.utils import timing
from sober_bench import registry
assert not timing.TRACE.enabled
registry.metric("prog.pdf_ms")
print("ENABLED", timing.TRACE.enabled)
"""


def test_importing_a_reader_switches_the_recorder_on():
    out = subprocess.run([sys.executable, "-c", PROBE, REPO], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "ENABLED True"
