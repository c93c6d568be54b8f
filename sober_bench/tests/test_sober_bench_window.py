"""The measured window, on a stub loop whose rounds take a set time on a
clock moved by hand: a traced window gives its spans, reads and profiled
phases MIN_PHASE_ROUNDS rounds each whatever a round takes, running past
its deadline by whole rounds where it must; a plain window makes one phase
and closes at its first round start past the deadline; a traced result
carries busy_s and window_s, or the run exits non-zero with no result."""
import sys
import types

import pytest
import torch

from tiny import REPO

sys.path.insert(0, REPO)
from sober_bench import harness  # noqa: E402
from sober_bench import probe as pr  # noqa: E402

MIN = harness.MIN_PHASE_ROUNDS


class Clock:
    def __init__(self):
        self.s = 1000.0

    def perf_counter(self):
        return self.s

    def time(self):
        return self.s


class StubLoop:
    """Rounds whose next_batch takes durations[i] seconds of the clock (the
    last duration again past the list); an episode start takes none."""

    fit_span = "fit.stub"

    def __init__(self, clock, durations):
        self.clock, self.durations, self.n = clock, durations, 0

    def start(self, seed, probe):
        return types.SimpleNamespace(sober=types.SimpleNamespace())

    def fit(self, ep):
        return None

    def update(self, ep, model, probe):
        pass

    def next_batch(self, ep):
        self.clock.s += self.durations[min(self.n, len(self.durations) - 1)]
        self.n += 1

    def keep(self, ep, model, out, record):
        pass

    def observe(self, ep, out):
        pass


@pytest.fixture
def stub(monkeypatch):
    """A cell of 15-round episodes over a stub loop; the profiler's phase
    opens and closes a range and reads no trace."""
    clock = Clock()
    monkeypatch.setattr(harness, "time", clock)
    profiled = []
    monkeypatch.setattr(harness.Cell, "_start_profile",
                        lambda self, entries: (profiled.append(clock.s) or "prof", None))
    monkeypatch.setattr(harness.Cell, "_end_profile",
                        lambda self, prof, ranges: ("stretch", {}))

    def make(durations):
        cell = harness.Cell.__new__(harness.Cell)
        cell.name, cell.device = "stub", torch.device("cpu")
        cell.workload = {"check": {"rounds": 2}}
        cell.traffic = {"rounds": 15, "campaigns": 2, "campaign_seed": 14}
        cell.loop = StubLoop(clock, durations)
        cell.probe = pr.Probe(cell.sync)
        return cell

    return types.SimpleNamespace(clock=clock, make=make, profiled=profiled)


def _window(stub, durations, seconds, traced):
    cell = stub.make(durations)
    t0 = stub.clock.s
    window_s, starts, t_stop, _, _, readings = cell.measure(
        2**31 + 5, seconds, {} if traced else None)
    return [s - t0 for s in starts], t_stop - t0, readings


@pytest.mark.parametrize("durations, seconds", [
    ([2.0 / 3], 2.0),                      # rounds of a third of the window
    ([0.1] * 11 + [1.5] + [0.1], 2.0),     # a storm across the 60% and 85% edges
    ([0.1] * 5 + [5.0] + [0.1], 2.0),      # a storm past the deadline in the spans
    ([0.05], 2.0),                         # many short rounds
], ids=["long-rounds", "storm-across-edges", "storm-past-deadline", "short-rounds"])
def test_a_traced_window_gives_every_phase_its_rounds(stub, durations, seconds):
    starts, end, readings = _window(stub, durations, seconds, traced=True)
    assert list(readings.phases) == ["spans", "reads", "profile"]
    assert all(n >= MIN for n in readings.phases.values()), readings.phases
    assert sum(readings.phases.values()) == len(starts)
    assert readings.stretch == "stretch" and len(stub.profiled) == 1
    # it closes at the first round start past the deadline that finds the
    # stretch whole, so its last round started before the deadline or was
    # one the stretch needed
    assert end >= seconds and readings.overrun_s == pytest.approx(end - seconds)
    assert starts[-1] < seconds or readings.phases["profile"] == MIN


def test_phases_keep_their_shares_when_rounds_are_short(stub):
    starts, end, readings = _window(stub, [0.0625], 2.0, traced=True)
    # 32 rounds of 1/16 s: the spans to 1.2 s, the reads to 1.7 s, the
    # stretch to the deadline
    assert readings.phases == {"spans": 20, "reads": 8, "profile": 4}
    assert len(starts) == 32 and readings.overrun_s == pytest.approx(0.0)


def test_long_rounds_hand_over_early_and_run_past_the_deadline(stub):
    starts, end, readings = _window(stub, [2.0 / 3], 2.0, traced=True)
    assert readings.phases == {"spans": MIN, "reads": MIN, "profile": MIN}
    assert end == pytest.approx(3 * MIN * 2.0 / 3)


def test_a_phase_hands_over_when_later_phases_would_not_fit(stub):
    # in a 4 s window the spans' share ends at 2.4 s. Rounds of 0.25 s reach
    # it first; with rounds of 0.375 s the six rounds that the reads and the
    # stretch need (2.25 s) outrun the time left from 1.875 s on
    _, _, short = _window(stub, [0.25], 4.0, traced=True)
    assert short.phases["spans"] == 10
    stub.clock.s = 1000.0
    _, end, longer = _window(stub, [0.375], 4.0, traced=True)
    assert longer.phases == {"spans": 5, "reads": MIN, "profile": MIN}
    assert end == pytest.approx(4.125)
    assert harness.hands_over(0, MIN, 1.875, 4.0, 0.375)
    assert not harness.hands_over(0, MIN, 1.75, 4.0, 0.375)
    assert not harness.hands_over(0, MIN - 1, 3.9, 4.0, 0.375)
    assert not harness.hands_over(2, 99, 9.0, 4.0, 0.375)


def test_a_plain_window_makes_one_phase_and_closes_at_the_deadline(stub):
    starts, end, readings = _window(stub, [0.3], 2.0, traced=False)
    # starts at 0, 0.3, ..., 1.8; the start at 2.1 finds the window closed
    assert starts == pytest.approx([0.3 * i for i in range(7)])
    assert end == pytest.approx(2.1) and readings.overrun_s == pytest.approx(0.1)
    assert list(readings.phases) == ["plain"] and not stub.profiled
    # a storm past the deadline ends it too, with a single round
    stub.clock.s = 1000.0
    starts, end, readings = _window(stub, [5.0], 2.0, traced=False)
    assert starts == [0.0] and end == pytest.approx(5.0)


class FakeStretch:
    def __init__(self, events, busy_s, window_s=2.0):
        self.n_device_events, self.busy_s, self.window_s = events, busy_s, window_s
        self.device_ops, self.idle_gaps = [["k", busy_s]], [["none", window_s - busy_s]]


class FakeCell:
    """Stands in for a cell on the card: a warm-up and a window of one
    round that hands back the given stretch."""

    def __init__(self, stretch):
        self.stretch = stretch

    def __call__(self, name, device):
        return self

    def warm(self):
        pass

    def measure(self, seed, seconds, entries=None):
        r = harness.Readings()
        r.stretch, r.phases, r.overrun_s = self.stretch, {"spans": 3, "reads": 3}, 0.5
        r.entries = {"car": [({"m": 400, "q": 200, "elim": None}, 1e-3)] * 2}
        return 1.0, [0.0], 1.0, [], 0, r

    def judge(self, records):
        return False, {}, 0


@pytest.mark.parametrize("stretch", [None, FakeStretch(0, 0.0), FakeStretch(5, 0.0)],
                         ids=["no-stretch", "no-device-events", "no-busy-time"])
def test_a_traced_run_without_device_work_exits_non_zero(monkeypatch, capsys, stretch):
    monkeypatch.setattr(harness, "Cell", FakeCell(stretch))
    out, code = harness.run("shekel-b100", 1, 1.0, True, 0.0)
    assert code != 0 and out == {}
    assert "{'spans': 3, 'reads': 3}" in capsys.readouterr().err


def test_a_traced_result_has_busy_s_and_window_s(monkeypatch):
    monkeypatch.setattr(harness, "Cell", FakeCell(FakeStretch(7, 0.5)))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "card")
    monkeypatch.setattr(harness.registry, "per_layer_for", lambda *_: [])
    out, code = harness.run("shekel-b100", 1, 1.0, True, 0.0)
    assert code == 0
    assert out["device"]["busy_s"] == 0.5 and out["device"]["window_s"] == 2.0
    assert out["phases"] == {"spans": 3, "reads": 3} and out["overrun_s"] == 0.5
    assert out["stretch_calls"] == {"car": {"m=400,q=200": 2}}
    assert list(out)[-1] == "checks"
