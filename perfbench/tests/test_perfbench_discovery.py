"""Configurations, traffic mixes, limits, ops and per-layer metrics are
found by the names in ``BENCHMARK.json``: adding one takes new files and
new entries only."""

import json
import shutil
import sys
import types

import pytest

from perfbench.harness import spec
from perfbench.harness.cell import Readings
from perfbench.harness.trace import Summary

BENCH = spec.load_bench()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves_by_name(w):
    cell = spec.load_cell(w["name"], BENCH)
    assert cell.mix["mode"] in ("daemon", "mesh")
    assert (spec.HERE / "ops" / f"{cell.config['op']}.py").exists()
    assert cell.limits
    if cell.chips > 1:
        assert len(cell.config["mesh"]) == 2


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_a_reader(m):
    assert callable(spec.metric_reader(m["name"]))


def test_new_files_are_found_without_edits(tmp_path, monkeypatch):
    here = tmp_path / "perfbench"
    for sub in ("traffic", "limits", "configs"):
        shutil.copytree(spec.HERE / sub, here / sub)
    (here / "traffic" / "tiny.json").write_text(json.dumps(
        {"clients": 2, "mode": "daemon", "sizes": [256],
         "powers": [5, 9], "pool": 1, "sample": 0.5, "sample_cap": 1}))
    (here / "configs" / "matpow-f64.json").write_text(json.dumps(
        {"name": "matpow-f64", "op": "matpow", "dtype": "float64",
         "operand": {"kind": "power", "eps": 0.03125}}))
    (here / "limits" / "matpow-f64.tiny.json").write_text(json.dumps(
        {"rel_err": {"limit": 1e-9}}))
    metrics = tmp_path / "extra_metrics"
    metrics.mkdir()
    (metrics / "answers_seen.py").write_text(
        "def read(r):\n    return float(len(r.in_window)) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "matpow-f64",
                             "file": "perfbench/configs/matpow-f64.json",
                             "source": "x", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "matpow-f64.tiny",
                               "config": "matpow-f64", "traffic": "tiny",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answers_seen", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "requests_per_s",
                               "workloads": ["matpow-f64.tiny"]})
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    import perfbench.metrics
    monkeypatch.setattr(perfbench.metrics, "__path__",
                        list(perfbench.metrics.__path__) + [str(metrics)])
    cell = spec.load_cell("matpow-f64.tiny", bench)
    assert cell.config["dtype"] == "float64"
    assert cell.mix["sizes"] == [256]
    # Every per-layer metric, those that list other cells too: a reader
    # that finds nothing to read in the new cell returns None.
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in BENCH["per_layer"]] + ["answers_seen"]
    assert spec.metric_reader("squarings_per_request")(_readings()) is None
    readings = Readings("matpow", "daemon", 3, [object()] * 3, [], [], {},
                        None, 0.0)
    assert spec.metric_reader("answers_seen")(readings) == 3.0
    sys.modules.pop("perfbench.metrics.answers_seen", None)


def _readings(**kw):
    base = dict(op="matpow", mode="daemon", submitted=0,
                in_window=[], traced=[], multiplies=[],
                counters={"requests": 0, "buckets": 0, "launches": 0,
                          "stages": {s: (0, 0.0) for s in
                                     ("queue", "assemble", "resolve")}},
                summary=None, work_bound_s=0.0)
    base.update(kw)
    return Readings(**base)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_a_reader_with_nothing_to_read_returns_nothing(m):
    assert spec.metric_reader(m["name"])(_readings()) is None


def test_shares_are_reckoned_from_the_trace():
    done = [types.SimpleNamespace(submit_s=1e-4)] * 4
    s = Summary(busy_s=2.0, window_s=4.0, syncs=8, nccl_s=0.2,
                device_ops=[], idle_gaps=[])
    r = _readings(in_window=done, traced=done, multiplies=[7] * 4,
                  summary=s, work_bound_s=1.5, mode="mesh", submitted=4,
                  counters={"launches": 40})
    read = spec.metric_reader
    assert read("matmul_roofline")(r) == pytest.approx(75.0)
    assert read("device_idle_pct")(r) == pytest.approx(50.0)
    assert read("host_syncs_per_request")(r) == pytest.approx(2.0)
    assert read("collective_ms_per_request")(r) == pytest.approx(50.0)
    assert read("launches_per_request")(r) == pytest.approx(10.0)
    assert read("squarings_per_request")(r) is None
