"""The harness finds configurations, cells and per-layer metrics by name,
and a new one is added as new files and entries only."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from tiny import REPO

sys.path.insert(0, REPO)
from sober_bench import harness, registry  # noqa: E402


def test_every_name_in_the_manifest_is_found():
    bench = registry.benchmark()
    for c in bench["configs"]:
        cfg = registry.config(c["name"])
        assert cfg["name"] == c["name"] and c["file"].endswith(f"configs/{c['name']}.json")
        assert hasattr(registry.config_module(cfg), "objective" if cfg["loop"] == "continuous"
                       else "load")
        assert hasattr(registry.loop(cfg["loop"]), "Loop")
    for w in bench["workloads"]:
        wl = registry.workload(w["name"])
        assert wl["config"] == w["config"] and set(wl["limits"]) >= {"batch_faults"}
        names = {m["name"] for m in registry.per_layer_for(w["name"], bench)}
        assert names == {m["name"] for m in bench["per_layer"] if w["name"] in m["workloads"]}
    for m in bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_a_missing_name_is_an_error():
    with pytest.raises(FileNotFoundError):
        registry.workload("no-such-cell")


DUMMY_METRIC = '''"""dummy_ms: the mean milliseconds of the observe span."""


def read(r):
    ms = [1e3 * s for s in r.spans.get("observe", [])]
    return sum(ms) / len(ms) if ms else None
'''


def _digests(root):
    return {p: hashlib.sha256(open(os.path.join(root, p), "rb").read()).hexdigest()
            for p in (os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
            if "__pycache__" not in p and not p.startswith((".cache", ".runs"))}


def test_a_new_config_cell_and_metric_need_no_edit(tmp_path):
    copy = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, "sober_bench"), copy / "sober_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", ".runs"))
    before = _digests(copy / "sober_bench")
    bench = registry.benchmark()
    cfg = registry.config("shekel")
    cfg.update(name="shekel2", n_init=50)
    (copy / "sober_bench/configs/shekel2.json").write_text(json.dumps(cfg))
    wl = registry.workload("shekel-b100")
    wl.update(name="shekel2-b50", config="shekel2")
    wl["traffic"].update(batch=50)
    (copy / "sober_bench/workloads/shekel2-b50.json").write_text(json.dumps(wl))
    (copy / "sober_bench/metrics/dummy_ms.py").write_text(DUMMY_METRIC)
    bench["configs"].append(dict(bench["configs"][0], name="shekel2",
                                 file="sober_bench/configs/shekel2.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="shekel2-b50", config="shekel2"))
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "Objective",
                               "moves": "round_s", "workloads": ["shekel2-b50"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    assert _digests(copy / "sober_bench").items() >= before.items()
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
        "from sober_bench import registry, harness;"
        "assert registry.ROOT.parent.as_posix() == sys.argv[1];"
        "names = [m['name'] for m in registry.per_layer_for('shekel2-b50')];"
        "assert 'dummy_ms' in names, names;"
        "r = harness.Readings(); r.spans['observe'] = [0.002, 0.004];"
        "assert abs(registry.metric('dummy_ms').read(r) - 3.0) < 1e-9;"
        "c = harness.Cell('shekel2-b50', 'cpu');"
        "assert c.traffic['batch'] == 50 and c.config['n_init'] == 50;"
        "print('ok')")
    out = subprocess.run([sys.executable, "-c", probe, str(copy), REPO],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_checked_rounds_and_the_order_are_drawn_from_the_seed():
    a = harness.checked_rounds(2**31 + 12345, 15, 6)
    assert a == harness.checked_rounds(2**31 + 12345, 15, 6) and len(a) == 6
    assert (0, 14) in a
    order = harness.campaign_order(2**33 + 1, 6)
    assert sorted(order) == list(range(6)) and order == harness.campaign_order(2**33 + 1, 6)
    assert {tuple(harness.campaign_order(s, 6)) for s in range(20)} != {tuple(order)}
    assert harness.campaign_seed(14, 3) == harness.campaign_seed(14, 3)
    assert 0 <= harness.campaign_seed(14, 3) < 2**31 != harness.campaign_seed(14, 4)


def test_end_to_end_takes_the_whole_window():
    e2e = harness.end_to_end(10.0, [0.0, 1.0, 2.0, 4.0], 10.0, 2**30, 3.0)
    assert e2e["round_s"] == 2.5 and e2e["peak_mem_gib"] == 1.0 and e2e["setup_s"] == 3.0
    # each round to the next one's start, the last to the window's end
    # durations 1, 1, 2, 6: the inclusive 90th percentile lies 0.7 of the
    # way from 2 to 6
    assert e2e["round_p90_s"] == pytest.approx(4.8)


def test_the_answer_rounds_are_each_episodes_first():
    seed = 2**31 + 12345
    base = harness.checked_rounds(seed, 15, 6)
    both = harness.checked_rounds(seed, 15, 6, answer_episodes=6, answer_rounds=1)
    assert both == base | {(e, 0) for e in range(6)}


def test_candidates_pair_spans_by_round(capsys):
    r = harness.Readings()
    r.spans = {"next_batch": [0.010, 0.020, 0.030], "recombination": [0.004, 0.001, 0.002]}
    r.span_rounds = {"next_batch": [5, 6, 7], "recombination": [5, 5, 7]}
    # round 5 ran recombination twice, round 6 not at all
    value = registry.metric("candidates_ms").read(r)
    assert value == pytest.approx(1e3 * ((0.010 - 0.005) + 0.020 + (0.030 - 0.002)) / 3)
    assert "rounds without a recombination span [6]" in capsys.readouterr().err
    r.span_rounds["recombination"] = [5, 6, 7]
    assert registry.metric("candidates_ms").read(r) == pytest.approx(1e3 * 0.053 / 3)
    assert capsys.readouterr().err == ""


def test_a_screening_cell_reads_its_rounds_and_layers_per_layer():
    r = harness.Readings()
    assert registry.metric("round_s.screen").read(r) is None
    r.e2e = harness.end_to_end(10.0, [0.0, 1.0, 2.0, 4.0], 10.0, 2**30, 3.0)
    assert registry.metric("round_s.screen").read(r) == 2.5
    assert registry.metric("round_p90_s.screen").read(r) == pytest.approx(4.8)
    r.spans = {"next_batch": [0.010, 0.020], "recombination": [0.004, 0.002]}
    r.span_rounds = {"next_batch": [0, 1], "recombination": [0, 1]}
    for name in ("next_batch_ms", "candidates_ms", "recombination_ms"):
        assert registry.metric(name + ".screen").read(r) == registry.metric(name).read(r)
    assert registry.metric("car.roofline_pct.screen").ENTRY == \
        registry.metric("car.roofline_pct").ENTRY


def test_a_reader_under_a_cell_suffix_needs_no_file_of_its_own():
    # next_batch_ms.screen has no file: it is next_batch_ms's reader, while
    # round_s.screen, which reads an end-to-end figure, keeps its own
    assert registry.metric("next_batch_ms.screen") is registry.metric("next_batch_ms")
    assert registry.metric("prog.pi_ms.screen") is registry.metric("prog.pi_ms")
    assert registry.metric("fit_ms.exact") is not registry.metric("fit_ms.tanimoto")
    assert registry.metric("round_s.screen").__name__.endswith("round_s.screen.py")
    with pytest.raises(FileNotFoundError):
        registry.metric("no_such_ms.screen")
