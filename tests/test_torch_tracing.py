"""The port's recorder (sober_tpu_torch/utils/timing.py) on the CPU: off it is
one shared no-op; on it records spans with their parents, calls, counters and
self times; under torch.profiler its ranges land in the trace; a small fit
and next_batch record the layers' spans and count every host read the
port's own lines make; the batches do not change with it."""
import json
import sys

import numpy as np
import pytest
import torch

from sober_tpu_torch import DatasetPrior, Sober, fit_tanimoto_gp
from sober_tpu_torch.core import fused_sampling as fs
from sober_tpu_torch.gp import exact
from sober_tpu_torch.gp.exact import fit_gp_padded
from sober_tpu_torch.priors import Uniform
from sober_tpu_torch.utils import timing

CPU = torch.device("cpu")
# the Tensor methods through which Python code reads a device value
READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu")


@pytest.fixture
def trace(monkeypatch):
    """A fresh program recorder, on, for the test."""
    tr = timing.Tracer(device=CPU, enabled=True)
    monkeypatch.setattr(timing, "TRACE", tr)
    return tr


class Clock:
    """perf_counter_ns, moved by hand (ms)."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns

    def at(self, ms):
        self.ns = int(ms * 1e6)


# the KeyRing draws its seeds from a generator on the CPU: no device read
HOST_SIDE = ("prng.py",)


@pytest.fixture
def reads(monkeypatch):
    """Counts the reads that the port's own lines make, by file:line."""
    hits = []

    def counting(name):
        orig = getattr(torch.Tensor, name)

        def wrapper(self, *args, **kwargs):
            code = sys._getframe(1).f_code
            if ("sober_tpu_torch" in code.co_filename
                    and not code.co_filename.endswith(HOST_SIDE)):
                hits.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{sys._getframe(1).f_lineno}")
            return orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, wrapper)

    for name in READS:
        counting(name)
    return hits


def _host_reads(call) -> int:
    return sum(n for k, n in call["counts"].items() if k.startswith("host_reads."))


def test_off_the_recorder_is_one_shared_noop(monkeypatch):
    tr = timing.Tracer(device=CPU, enabled=False)
    monkeypatch.setattr(timing, "TRACE", tr)
    assert timing.span("fit") is timing.span("next_batch") is timing.NOOP
    with timing.span("fit"):
        timing.count("fit.steps")
        timing.count("sampler.n_pos", 3)
    assert tr.summary() == {} and tr.counts() == {} and tr.calls() == []
    # a timed span still times the host clock, and records nothing
    with timing.timed("next_batch") as s:
        pass
    assert s.seconds >= 0 and tr.summary() == {}
    # a kept span records whatever the switch says, in no call
    with timing.timed("setup.library", keep=True):
        pass
    assert tr.summary()["setup.library"]["count"] == 1 and tr.calls() == []


def test_on_spans_nest_into_calls_with_counters_and_self_time(trace, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(timing, "time", clock)
    timing.count("host_reads.n_init")                # outside any call
    with timing.span("next_batch") as top:
        clock.at(1)
        with timing.span("sampler.draw") as draw:
            timing.count("host_reads.refill", 2)
            timing.count("sampler.n_pos", 7)
            clock.at(4)
            # a span inside one of its own name is merged into it
            assert timing.span("sampler.draw") is timing.NOOP
        with timing.span("recombination"):
            clock.at(6)
        clock.at(10)
    with timing.span("next_batch"):
        timing.count("host_reads.refill")
        clock.at(12)
    assert draw.parent is top and top.parent is None and draw.call is top.call
    s = trace.summary()
    assert s["next_batch"]["count"] == 2
    assert s["next_batch"]["total_s"] == pytest.approx(0.012)
    # 10 ms less the 3 + 2 ms of its children, and the second call's 2 ms
    assert s["next_batch"]["self_s"] == pytest.approx(0.007)
    assert s["sampler.draw"]["self_s"] == pytest.approx(0.003)
    assert s["next_batch"]["stream_s"] is None            # no stream clock here
    calls = trace.calls("next_batch")
    assert [c["id"] for c in calls] == [0, 1]
    assert calls[0]["counts"] == {"host_reads.refill": 2, "sampler.n_pos": 7}
    assert calls[1]["counts"] == {"host_reads.refill": 1}
    assert trace.counts() == {"host_reads.n_init": 1, "host_reads.refill": 3,
                              "sampler.n_pos": 7}
    assert trace.per_call("next_batch", prefix="host_reads") == 1.5
    assert trace.per_call("next_batch", span="recombination") == pytest.approx(0.001)
    assert trace.per_call("fit", span="fit") is None
    assert list(trace.records["next_batch"]) == pytest.approx([0.010, 0.002])


def test_under_the_profiler_the_ranges_are_in_the_trace(trace, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("fit"):
            with timing.span("fit.loss"):
                torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"sober.fit", "sober.fit.loss"} <= names
    # marked, so that readers leave them out
    (call,) = trace.calls("fit")
    assert call["profiled"] and trace.per_call("fit", span="fit") is None
    assert set(trace.summary()) == {"fit", "fit.loss"}


def _branin_round():
    """A small continuous campaign's start: a Uniform box, 12 of its Sobol
    points and their values (a scaled Branin)."""
    prior = Uniform(torch.tensor([[-5.0, 0.0], [10.0, 15.0]]), seed=3, device=CPU)
    x = prior.sample(torch.Generator().manual_seed(3), 12)
    y = -((x[:, 1] - 0.13 * x[:, 0] ** 2 + 1.6 * x[:, 0] - 6) ** 2) / 50.0
    return prior, x, y


def test_a_fit_records_its_steps_and_counts_its_reads(trace, reads):
    _, x, y = _branin_round()
    fit_gp_padded(x, y, bucket=16)
    (call,) = trace.calls("fit")
    assert {"fit", "fit.loss", "fit.grad", "fit.update", "fit.state"} <= set(call["spans"])
    counts = call["counts"]
    steps = call["spans"]["fit.update"][0]
    assert counts["fit.steps"] == steps == call["spans"]["fit.grad"][0]
    # every step's loss, and the final and best losses
    assert counts["fit.evals"] == steps + 2 == call["spans"]["fit.loss"][0]
    assert counts["host_reads.loss"] == steps and counts["host_reads._loss"] == 2
    assert _host_reads(call) == len(reads)


def test_lbfgs_fit_and_the_dataset_next_batch(trace, reads):
    rng = np.random.default_rng(5)
    feats = (rng.random((400, 64)) < 0.2).astype(np.float32)
    prior = DatasetPrior(feats, feats.sum(1), device=CPU)
    xo, yo = prior.sample(torch.Generator().manual_seed(5), 20)
    model = fit_tanimoto_gp(xo, yo)
    (fit,) = trace.calls("fit")
    # a step is tiled: the optimiser's work before and after each evaluation
    spans = fit["spans"]
    assert spans["fit.update"][0] == fit["counts"]["fit.steps"] + spans["fit.grad"][0]
    assert fit["counts"]["fit.evals"] == fit["spans"]["fit.loss"][0]
    assert _host_reads(fit) == len(reads)
    sober = Sober(prior, model, kernel_type="weighted_predictive_covariance")
    del reads[:]
    sober.next_batch(150, 100, 10)
    (call,) = trace.calls("next_batch")
    assert {"next_batch", "next_batch.dataset", "next_batch.candidates", "sampler.pi",
            "sampler.prune", "sampler.nystrom", "recombination", "recombination.basis",
            "recombination.final"} <= set(call["spans"])
    assert _host_reads(call) == len(reads) > 0
    assert set(sober.last_timings) == {"fused_iteration", "total"}


def test_continuous_next_batch_records_the_layers(trace, reads):
    prior, x, y = _branin_round()
    sober = Sober(prior, fit_gp_padded(x, y, bucket=16))
    del reads[:]
    xb = sober.next_batch(2000, 400, 10, polish=True)
    (call,) = trace.calls("next_batch")
    assert {"next_batch", "next_batch.candidates", "sampler.draw", "sampler.pdf",
            "sampler.pi", "sampler.update_prior", "sampler.nystrom", "recombination",
            "recombination.basis", "recombination.round", "recombination.final",
            "next_batch.polish"} <= set(call["spans"])
    for site in ("weight_health", "refill", "nystrom_basis", "null_basis", "_targets",
                 "jitter_cholesky"):
        assert call["counts"].get("host_reads." + site, 0) > 0, site
    assert _host_reads(call) == len(reads)
    assert call["counts"]["sampler.n_pos"] > 0
    assert set(sober.last_timings) == {"candidates", "recombination", "polish", "total"}
    # the next round, whose proposal resets
    y2 = torch.cat([y, y[:10] - 1.0])
    sober.update_model(fit_gp_padded(torch.cat([x, xb]), y2, bucket=16))
    sober.next_batch(2000, 400, 8, recycle_prior=False)
    assert trace.calls("next_batch")[-1]["counts"]["sampler.resets"] == 1
    assert set(sober.last_timings) == {"candidates", "recombination", "total"}
    assert len(trace.calls("update_model")) == 1


def test_refill_rounds_and_the_cholesky_retry(trace):
    n = 64
    gen = torch.Generator().manual_seed(0)
    draw = lambda: (torch.rand((n, 2), generator=gen), torch.rand(n, generator=gen))
    with timing.span("next_batch"):
        _, _, none, rounds = fs.refill(draw, torch.zeros((n, 2)), torch.zeros(n), 5, 5)
    (call,) = trace.calls("next_batch")
    assert not none and call["counts"]["sampler.refill_rounds"] == rounds - 1 >= 1
    assert call["spans"]["sampler.refill"][0] == rounds - 1
    assert call["counts"]["host_reads.refill"] == rounds
    assert call["counts"]["sampler.n_pos"] == n
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])                     # indefinite
    exact._rescued_cholesky(bad, torch.tensor(5.0))
    counts = trace.counts()
    assert counts["fit.cholesky_retries"] == 1
    # info > 0 settles it: the NaN check is not read
    assert counts["host_reads.cholesky"] == 1


def test_an_lbfgs_regression_counts_the_adam_fallback(trace, monkeypatch):
    _, x, y = _branin_round()
    worse = lambda p0, *a, **k: exact.map_params(lambda t: t + 50.0, p0)
    monkeypatch.setattr(exact, "_fit_lbfgs", worse)
    exact.fit_gp(x, (y - y.mean()) / y.std(), optimiser="lbfgs")
    assert trace.counts()["fit.adam_fallbacks"] == 1


@pytest.mark.parametrize("verbose", [False, True])
def test_the_recorder_leaves_the_batches_as_they_are(monkeypatch, verbose):
    def round_():
        prior, x, y = _branin_round()
        sober = Sober(prior, fit_gp_padded(x, y, bucket=16))
        return sober.next_batch(2000, 100, 10, verbose=verbose)

    monkeypatch.setattr(timing, "TRACE", timing.Tracer(device=CPU, enabled=False))
    off = round_()
    timing.enable(CPU)
    on = round_()
    assert torch.equal(off, on) and timing.TRACE.calls("next_batch")
