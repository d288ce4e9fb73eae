"""The yardstick's arithmetic and the file's form: traffic by seed, work
counts, the roofline bound, percentiles, names and units."""

import json
import math
import statistics

import pytest

from perfbench.harness import spec, stats, trace, traffic, work

BENCH = spec.load_bench()


def _take(mix, seed, client, k):
    stream = traffic.client_requests(mix, seed, client)
    return [next(stream) for _ in range(k)]


@pytest.mark.parametrize("mix", ["large", "ncd", "stack", "solo"])
def test_traffic_is_deterministic_by_seed(mix):
    with open(spec.HERE / "traffic" / f"{mix}.json") as f:
        m = json.load(f)
    seed = 3_000_000_000_123          # wider than 32 bits
    assert _take(m, seed, 0, 200) == _take(m, seed, 0, 200)
    assert _take(m, seed, 0, 200) != _take(m, seed + 1, 0, 200)
    if m["clients"] > 1:
        assert _take(m, seed, 0, 200) != _take(m, seed, 1, 200)


def test_every_seed_asks_for_the_same_work():
    with open(spec.HERE / "traffic" / "large.json") as f:
        m = json.load(f)
    cycle = len(m["powers"]) * m["pool"]
    for seed in (1, 2 ** 40 + 3):
        reqs = _take(m, seed, 0, cycle)
        assert sorted(r.power for r in reqs) == sorted(m["powers"] * m["pool"])
        assert sorted(r.operand for r in reqs) == sorted(
            list(range(m["pool"])) * len(m["powers"]))
    with open(spec.HERE / "traffic" / "stack.json") as f:
        m = json.load(f)
    sizes = [r.n for r in _take(m, 5, 3, 100)]
    assert sizes.count(512) == sizes.count(1024) == 50


@pytest.mark.parametrize("p,squarings,combines",
                         [(96, 6, 1), (255, 7, 7), (64, 6, 0), (1, 0, 0),
                          (2, 1, 0), (3, 1, 1)])
def test_work_counts_match_hand_counts(p, squarings, combines):
    assert work.matpow_multiplies(p) == squarings + combines


def test_roofline_bound_from_shapes():
    n = 4096
    flops = 2 * n ** 3
    assert work.dense_bound_s(n, "float32", 1) == pytest.approx(
        flops / 67e12)
    assert work.dense_bound_s(n, "float64", 14, share=0.25) == \
        pytest.approx(14 * flops / 67e12 / 4)
    # A small bf16 product is bound by its bytes, not its operations.
    m = 64
    assert work.dense_bound_s(m, "bfloat16", 1) == pytest.approx(
        3 * m * m * 2 / 3.35e12)


def test_percentiles_are_over_all_samples():
    xs = list(range(1, 1001))
    assert stats.percentile(xs, 50) == pytest.approx(500.5)
    assert stats.percentile(xs, 95) == pytest.approx(950.05)
    assert stats.percentile(reversed(xs), 95) == stats.percentile(xs, 95)
    assert stats.percentile([7.0], 95) == 7.0
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def _names():
    out = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", _names())
def test_names_use_allowed_characters(name):
    assert spec.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_units_and_metric_keys(metric):
    assert spec.UNIT_RE.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", names)) <= names
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_file_keeps_to_its_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(BENCH["workloads"]) * 0.25))
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = spec.load_cell(w["name"], BENCH)
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
        assert "setup_s" in {e["name"] for e in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_the_trace_reduces_to_busy_time_syncs_and_gaps():
    ms = 1_000_000
    events = [
        ("perfbench.window", "host", -1, 0, 100 * ms),
        ("before the window", "device", 0, -50 * ms, -10 * ms),
        ("gemm", "device", 0, -5 * ms, 20 * ms),        # clipped at 0
        ("gemm", "device", 0, 10 * ms, 30 * ms),        # overlaps: union
        ("ncclKernel_SendRecv", "device", 0, 40 * ms, 50 * ms),
        ("gemm", "device", 1, 0, 100 * ms),              # another card
        ("nccl:send", "other", 0, 0, 100 * ms),          # a host mirror
        ("cudaStreamSynchronize", "host", -1, 28 * ms, 31 * ms),
        ("cudaLaunchKernel", "host", -1, 60 * ms, 61 * ms),
        ("cudaStreamSynchronize", "host", -1, 200 * ms, 210 * ms),
    ]
    s = trace.reduce_events(events, device_index=0)
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.040)          # [0, 30] + [40, 50]
    assert s.nccl_s == pytest.approx(0.010)
    assert s.syncs == 1
    assert s.device_ops == [["gemm", pytest.approx(0.040)],
                            ["ncclKernel_SendRecv", pytest.approx(0.010)]]
    # Gaps [50, 100] and [30, 40], longest first: at 75 ms the host was
    # in no call (after the launch at 60), at 35 ms after the sync.
    assert s.idle_gaps == [["host after cudaLaunchKernel",
                            pytest.approx(0.050)],
                           ["host after cudaStreamSynchronize",
                            pytest.approx(0.010)]]
