"""Telemetry of the port's serving stack: histogram quantiles, trace
completeness, export schema — the reference's tests/test_telemetry.py with
the imports swapped to ``repro_torch`` and the engine on ``device="cpu"``.

Covers the observability acceptance criteria:
  * ``Histogram`` quantiles hold the documented ``2**(1/8)`` relative
    error bound against a sorted-list reference, endpoints are exact,
    merge is exactly equivalent to recording into one histogram, and
    out-of-range values land in the clamp buckets without losing the
    exact count/sum/min/max;
  * ``MetricsRegistry`` label-subset merging — the per-lane stats rows
    must absorb per-tenant views recorded under the same lane;
  * ``Tracer`` ring-buffer bounds (overflow drops oldest + counts),
    disabled-tracer short-circuit, and the Chrome trace-event export
    schema (phases, track -> tid mapping, second -> microsecond
    conversion, arg coercion, thread-name metadata);
  * span-lifecycle completeness over a ``ManualClock`` daemon: EVERY
    submitted request — resolved, shed (both reject-newest and
    reject-oldest), errored, or cancelled — ends in exactly one terminal
    ``request`` span, and the lifecycle stages around it are present;
  * clock consistency: ``resolved_at`` and ``submitted_at`` share the
    ENGINE clock's epoch, so a ManualClock latency is the exact advanced
    interval (no epoch mixing);
  * tracing stays off by default: the no-config engine uses the shared
    ``NULL_TRACER`` and records nothing while serving real traffic.
"""

import json
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.runtime.telemetry import (NULL_TRACER, REQUEST_OUTCOMES,
                                     SPAN_KINDS, Histogram, MetricsRegistry,
                                     Tracer)
from repro_torch.serve.admission import (AdmissionControl, RejectNewest,
                                   RejectOldest, ShedError)
from repro_torch.serve.matfn import BucketExecutionError, MatFnEngine
from repro_torch.serve.scheduler import ManualClock, SystemClock

pytestmark = pytest.mark.timeout(120)

TIMEOUT = 30.0   # real-time backstop on future waits; never load-bearing

#: The documented worst-case quantile error: bucket upper bounds grow by
#: 2**(1/8) per bucket, so the reported quantile is within one growth
#: factor ABOVE the exact order statistic (and never below it).
GROWTH = 2.0 ** (1.0 / 8.0)


def _mat(n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((n, n)) * 0.4 / np.sqrt(n),
                        dtype=dtype)


def _ref_quantile(samples, q):
    """The exact order statistic the histogram approximates:
    sorted[ceil(q*n) - 1]."""
    s = sorted(samples)
    return s[max(1, math.ceil(q * len(s))) - 1]


class TestHistogram:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_quantiles_within_growth_factor_of_sorted_reference(self, seed):
        rng = np.random.default_rng(seed)
        # lognormal latencies well inside the default [1e-6, 1e3) range
        samples = np.exp(rng.normal(-7.0, 1.5, size=2000)).tolist()
        h = Histogram()
        for v in samples:
            h.record(v)
        for q in (0.01, 0.25, 0.50, 0.90, 0.95, 0.99):
            exact = _ref_quantile(samples, q)
            got = h.quantile(q)
            assert exact <= got <= exact * GROWTH * (1 + 1e-12), (q, exact,
                                                                  got)

    def test_exact_endpoints_and_moments(self):
        h = Histogram()
        samples = [3e-3, 1e-4, 7e-2, 5e-5, 2e-1]
        for v in samples:
            h.record(v)
        assert h.count == len(samples)
        assert h.sum == pytest.approx(sum(samples))
        assert h.mean == pytest.approx(sum(samples) / len(samples))
        assert h.quantile(0.0) == min(samples)   # exact, not bucketed
        assert h.quantile(1.0) == max(samples)

    def test_empty_and_degenerate(self):
        h = Histogram()
        assert h.quantile(0.5) is None and h.mean is None
        # all-zero samples (a ManualClock fill-flush latency) must answer
        # 0.0 — the clamp into [min, max] — never the underflow bound
        for _ in range(10):
            h.record(0.0)
        assert h.quantile(0.95) == 0.0
        assert h.min == 0.0 and h.max == 0.0
        with pytest.raises(ValueError):
            h.quantile(1.5)

    def test_out_of_range_values_clamp_but_count_exactly(self):
        h = Histogram(lo=1e-3, hi=1.0)
        h.record(1e-9)    # underflow
        h.record(50.0)    # overflow
        h.record(-2.0)    # negative: clock skew must not throw
        assert h.count == 3
        assert h.sum == pytest.approx(1e-9 + 50.0 - 2.0)
        assert h.min == -2.0 and h.max == 50.0
        # quantiles stay inside the exact envelope even for clamped data
        assert -2.0 <= h.quantile(0.5) <= 50.0

    def test_merge_equals_single_histogram(self):
        rng = np.random.default_rng(7)
        a_s = np.exp(rng.normal(-6, 1, 500)).tolist()
        b_s = np.exp(rng.normal(-8, 1, 700)).tolist()
        a, b, ref = Histogram(), Histogram(), Histogram()
        for v in a_s:
            a.record(v)
            ref.record(v)
        for v in b_s:
            b.record(v)
            ref.record(v)
        a.merge(b)
        assert a.count == ref.count
        assert a.sum == pytest.approx(ref.sum)
        assert (a.min, a.max) == (ref.min, ref.max)
        for q in (0.5, 0.95, 0.99):
            assert a.quantile(q) == ref.quantile(q)

    def test_merge_rejects_mismatched_geometry(self):
        with pytest.raises(ValueError, match="geometry"):
            Histogram().merge(Histogram(lo=1e-3))

    def test_constructor_rejections(self):
        with pytest.raises(ValueError):
            Histogram(lo=0.0)
        with pytest.raises(ValueError):
            Histogram(lo=1.0, hi=0.5)
        with pytest.raises(ValueError):
            Histogram(bits_per_octave=0)


class TestMetricsRegistry:
    def test_get_or_create_and_snapshot(self):
        reg = MetricsRegistry()
        reg.record("latency", 1e-3, lane="bulk")
        reg.record("latency", 2e-3, lane="bulk")
        reg.record("latency", 5e-3, lane="latency")
        assert reg.get("latency", lane="bulk").count == 2
        assert reg.get("latency", lane="nope") is None
        snap = reg.snapshot()
        assert snap["latency{lane=bulk}"]["count"] == 2
        assert snap["latency{lane=latency}"]["count"] == 1

    def test_merged_filters_by_label_subset(self):
        """The per-lane stats row must absorb per-tenant views recorded
        under the same lane — subset match, not exact match."""
        reg = MetricsRegistry()
        reg.record("latency", 1e-3, lane="bulk")
        reg.record("latency", 2e-3, lane="bulk", tenant="t0")
        reg.record("latency", 3e-3, lane="latency", tenant="t0")
        assert reg.merged("latency", lane="bulk").count == 2
        assert reg.merged("latency", tenant="t0").count == 2
        assert reg.merged("latency").count == 3        # no filter: all
        assert reg.merged("latency", lane="nope").count == 0

    def test_view_groups_by_name(self):
        reg = MetricsRegistry()
        reg.record("stage", 1e-4, stage="queue", stream="0")
        reg.record("stage", 2e-4, stage="execute", route="torch")
        reg.record("latency", 1e-3, lane="bulk")
        assert len(reg.view("stage")) == 2
        assert len(reg.view("latency")) == 1


class TestTracer:
    def test_records_spans_instants_counters(self):
        t = Tracer(clock=lambda: 42.0)
        t.add_span("bucket.execute", 1.0, 2.5, track="stream-0", route="torch")
        t.instant("compile", track="stream-0", key="k")
        t.counter("stream.queue_depth", 3, at=1.5, track="stream-0")
        spans = t.spans()
        assert [s["ph"] for s in spans] == ["X", "i", "C"]
        assert spans[0]["dur"] == pytest.approx(1.5)
        assert spans[1]["ts"] == 42.0            # clock-stamped instant
        assert spans[2]["args"]["value"] == 3
        assert len(t) == 3 and t.dropped == 0

    def test_lexical_span_uses_clock(self):
        ticks = iter([10.0, 13.0])
        t = Tracer(clock=lambda: next(ticks))
        with t.span("bucket.assemble", track="s", op="matpow"):
            pass
        (s,) = t.spans()
        assert (s["ts"], s["dur"]) == (10.0, 3.0)
        assert s["args"]["op"] == "matpow"

    def test_ring_buffer_drops_oldest_and_counts(self):
        t = Tracer(capacity=4, clock=lambda: 0.0)
        for i in range(10):
            t.instant("shed", at=float(i), rid=i)
        assert len(t) == 4 and t.dropped == 6
        assert [s["args"]["rid"] for s in t.spans()] == [6, 7, 8, 9]
        t.clear()
        assert len(t) == 0 and t.dropped == 0

    def test_disabled_tracer_records_nothing(self):
        t = Tracer(enabled=False, clock=lambda: 0.0)
        t.add_span("request", 0.0, 1.0)
        t.instant("shed")
        t.counter("depth", 1)
        with t.span("bucket.execute"):
            pass
        assert len(t) == 0 and t.dropped == 0
        assert len(NULL_TRACER) == 0 and not NULL_TRACER.enabled

    def test_chrome_export_schema(self, tmp_path):
        t = Tracer(clock=lambda: 0.0)
        t.add_span("request", 0.001, 0.003, track="requests",
                   rid=0, outcome="resolved", key=("matpow", 8))
        t.add_span("bucket.execute", 0.001, 0.002, track="stream-0")
        t.instant("compile", at=0.001, track="stream-0")
        t.counter("stream.queue_depth", 2, at=0.001, track="stream-0")
        path = tmp_path / "trace.json"
        t.export(path)
        doc = json.loads(path.read_text())
        events = doc["traceEvents"]
        assert doc["otherData"] == {"dropped_spans": 0, "recorded_spans": 4}
        metas = [e for e in events if e["ph"] == "M"]
        rest = [e for e in events if e["ph"] != "M"]
        # one thread_name record per track, tids consistent with events
        assert {m["args"]["name"] for m in metas} == {"requests", "stream-0"}
        tid_of = {m["args"]["name"]: m["tid"] for m in metas}
        assert all(isinstance(tid, int) for tid in tid_of.values())
        req, exe, comp, ctr = rest
        assert req["tid"] == tid_of["requests"]
        assert exe["tid"] == tid_of["stream-0"]
        # seconds -> microseconds, durations only on complete events
        assert req["ts"] == pytest.approx(1e3)
        assert req["dur"] == pytest.approx(2e3)
        assert "dur" not in comp and comp["s"] == "t"
        assert ctr["ph"] == "C" and ctr["args"]["value"] == 2
        # categories derive from the name prefix; non-scalar args coerce
        assert exe["cat"] == "bucket" and req["cat"] == "request"
        assert req["args"]["key"] == repr(("matpow", 8))

    def test_capacity_rejection(self):
        with pytest.raises(ValueError):
            Tracer(capacity=0)

    def test_chunked_snapshot_matches_full_copy(self):
        t = Tracer(capacity=100, clock=lambda: 0.0)
        for i in range(70):
            t.instant("e", at=0.0, rid=i)
        # chunk smaller than the ring: slices reassemble the exact sequence
        snap = t._snapshot_spans(chunk=7)
        assert [s["args"]["rid"] for s in snap] == list(range(70))
        with pytest.raises(ValueError):
            t._snapshot_spans(chunk=0)

    def test_export_during_concurrent_recording(self):
        # Regression: export used to copy the whole ring in one pass, so a
        # 65536-span trace either stalled every recording thread (copy
        # under the lock) or raced eviction mid-iteration. The chunked
        # snapshot releases the lock between slices; this hammers the ring
        # from a writer thread while exporting and checks the snapshot
        # stays duplicate-free, in record order, and JSON-clean.
        t = Tracer(capacity=2048, clock=lambda: 0.0)
        for i in range(2048):                    # start with a full ring
            t.instant("seed", at=0.0, rid=i)
        stop = threading.Event()
        wrote = [2048]

        def writer():
            i = 2048
            while not stop.is_set():
                t.instant("hot", at=0.0, rid=i)
                i += 1
            wrote[0] = i

        th = threading.Thread(target=writer)
        th.start()
        try:
            for _ in range(25):
                rids = [s["args"]["rid"]
                        for s in t._snapshot_spans(chunk=64)]
                assert rids == sorted(rids)      # record order survives
                assert len(set(rids)) == len(rids)   # no span copied twice
                doc = json.loads(json.dumps(t.to_chrome()))
                events = [e for e in doc["traceEvents"] if e["ph"] != "M"]
                assert doc["otherData"]["recorded_spans"] == len(events)
        finally:
            stop.set()
            th.join(timeout=30)
        assert not th.is_alive()
        # every overflow eviction was counted, none double-counted
        assert t.dropped == wrote[0] - 2048


class TestTracedWait:
    def test_deadline_kind_on_timeout_expiry(self):
        clock = SystemClock()
        tracer = Tracer(clock=clock.now)
        cv = threading.Condition()
        with cv:
            clock.traced_wait(cv, 0.01, tracer)
        (s,) = tracer.spans()
        assert s["name"] == "scheduler.wait"
        assert s["args"]["kind"] == "deadline"
        assert s["dur"] >= 0.01

    def test_wake_kind_on_notify(self):
        # ManualClock: time never moves during the wait, so a notify
        # always classifies as a wake — deterministically.
        clock = ManualClock()
        tracer = Tracer(clock=clock.now)
        cv = threading.Condition()
        clock.bind(cv)

        def waker():
            with cv:
                cv.notify_all()

        t = threading.Timer(0.05, waker)
        t.start()
        with cv:
            clock.traced_wait(cv, 10.0, tracer)
        t.join()
        (s,) = tracer.spans()
        assert s["args"]["kind"] == "wake"

    def test_disabled_tracer_is_plain_wait(self):
        cv = threading.Condition()
        with cv:
            SystemClock().traced_wait(cv, 0.005, NULL_TRACER)
        assert len(NULL_TRACER) == 0


def _terminal_spans(tracer):
    """rid -> list of terminal request spans (the exactly-once check)."""
    out = {}
    for s in tracer.spans():
        if s["name"] == "request":
            out.setdefault(s["args"]["rid"], []).append(s)
    return out


class TestEngineTracing:
    """Span-lifecycle completeness over the ManualClock daemon."""

    def test_resolved_requests_have_complete_span_chains(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0,
                          trace=True)
        eng.start()
        mats = [_mat(8, seed=i) for i in range(8)]
        futs = []
        for i, m in enumerate(mats):
            futs.append(eng.submit("matpow", m, power=3, tenant=f"t{i % 2}"))
            if i % 4 == 3:
                # The filled bucket leaves before the next one opens: a
                # submit that reaches a full bucket before the scheduler
                # does joins it, and the remainder would wait for a
                # deadline the ManualClock never reaches.
                eng.settle(timeout=TIMEOUT)
        for f in futs:
            f.result(timeout=TIMEOUT)
        eng.close()
        terminals = _terminal_spans(eng.tracer)
        assert sorted(terminals) == [f.rid for f in futs]
        for rid, spans in terminals.items():
            (s,) = spans                      # exactly one terminal span
            assert s["args"]["outcome"] == "resolved"
            assert s["args"]["op"] == "matpow" and s["args"]["n"] == 8
            assert s["args"]["tenant"] in ("t0", "t1")
            assert s["dur"] >= 0.0
        # the lifecycle stages around the terminals are all present
        names = {s["name"] for s in eng.tracer.spans()}
        for required in ("bucket.batch", "stream.queue", "bucket.assemble",
                         "bucket.execute", "bucket.resolve",
                         "scheduler.wait"):
            assert required in names, (required, sorted(names))
        # everything recorded is either a taxonomy span or a counter track
        assert names <= set(SPAN_KINDS) | {"stream.queue_depth"}, \
            names - set(SPAN_KINDS)
        # fill-triggered buckets say so on the bucket span
        batches = [s for s in eng.tracer.spans()
                   if s["name"] == "bucket.batch"]
        assert batches and all(b["args"]["trigger"] == "fill"
                               for b in batches)
        assert eng.tracer.dropped == 0
        # per-tenant latency views recorded alongside the lane view
        assert eng.metrics.merged("latency", tenant="t0").count == 4
        assert eng.metrics.merged("latency", lane="bulk").count == 8

    def test_resolved_at_shares_engine_clock_epoch(self):
        """The clock-consistency fix: a deadline-flushed request's
        latency is EXACTLY the advanced interval — both timestamps on the
        engine clock, neither on wall time."""
        clock = ManualClock(start=100.0)
        eng = MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0,
                          trace=True)
        eng.start()
        fut = eng.submit("matpow", _mat(8), power=3)
        assert fut.submitted_at == 100.0
        clock.advance(0.011)
        fut.result(timeout=TIMEOUT)
        assert fut.resolved_at - fut.submitted_at == pytest.approx(
            0.011, abs=1e-12)
        (s,) = _terminal_spans(eng.tracer)[fut.rid]
        assert s["ts"] == 100.0
        assert s["dur"] == pytest.approx(0.011, abs=1e-12)
        eng.close()

    def test_shed_reject_newest_emits_terminal_span(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=200, clock=clock, max_delay_ms=10.0,
                          trace=True,
                          admission=AdmissionControl(
                              capacity={"bulk": 2}, policy=RejectNewest()))
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]
        with pytest.raises(ShedError):
            eng.submit("matpow", _mat(8, seed=9), power=3)
        eng.close()
        terminals = _terminal_spans(eng.tracer)
        outcomes = {rid: spans[0]["args"]["outcome"]
                    for rid, spans in terminals.items()}
        assert sorted(outcomes.values()) == ["resolved", "resolved", "shed"]
        assert all(len(spans) == 1 for spans in terminals.values())
        sheds = [s for s in eng.tracer.spans() if s["name"] == "shed"]
        assert len(sheds) == 1 and sheds[0]["args"]["policy"] == \
            "reject-newest"
        for f in futs:
            assert f.exception(timeout=TIMEOUT) is None

    def test_shed_reject_oldest_victim_gets_terminal_span(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=200, clock=clock, max_delay_ms=10.0,
                          trace=True,
                          admission=AdmissionControl(
                              capacity={"bulk": 1}, policy=RejectOldest()))
        eng.start()
        f0 = eng.submit("matpow", _mat(8, seed=0), power=3)
        f1 = eng.submit("matpow", _mat(8, seed=1), power=3)
        assert isinstance(f0.exception(timeout=TIMEOUT), ShedError)
        eng.close()
        assert f1.exception(timeout=TIMEOUT) is None
        terminals = _terminal_spans(eng.tracer)
        assert terminals[f0.rid][0]["args"]["outcome"] == "shed"
        assert terminals[f1.rid][0]["args"]["outcome"] == "resolved"

    def test_error_outcome_on_executor_failure(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=2, clock=clock, max_delay_ms=10.0,
                          trace=True)

        def poisoned(op, route, bpad, n, dtype, power):
            raise RuntimeError("poisoned")

        eng._executable = poisoned
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]
        for f in futs:
            assert isinstance(f.exception(timeout=TIMEOUT),
                              BucketExecutionError)
        eng.close()
        terminals = _terminal_spans(eng.tracer)
        assert [terminals[f.rid][0]["args"]["outcome"] for f in futs] == \
            ["error", "error"]
        # bounded retries around the failure show up as retry instants
        assert any(s["name"] == "retry" for s in eng.tracer.spans())

    def test_cancelled_outcome_on_undrained_close(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0,
                          trace=True)
        eng.start()
        fut = eng.submit("matpow", _mat(8), power=3)
        eng.settle(TIMEOUT)
        eng.close(drain=False)
        from concurrent.futures import CancelledError
        assert isinstance(fut.exception(timeout=TIMEOUT), CancelledError)
        (s,) = _terminal_spans(eng.tracer)[fut.rid]
        assert s["args"]["outcome"] == "cancelled"
        assert s["args"]["outcome"] in REQUEST_OUTCOMES

    def test_stats_surfaces_histograms_stages_and_telemetry(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0,
                          trace=True)
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        snap = eng.stats()
        # histogram-backed lane quantiles: a ManualClock fill flush has
        # exactly-zero engine-clock latency — 0.0, never None
        assert snap["lanes"]["bulk"]["p95_ms"] == 0.0
        assert snap["lanes"]["bulk"]["p50_ms"] == 0.0
        for stage in ("queue", "assemble", "execute", "resolve"):
            assert snap["stages"][stage]["count"] > 0, (stage,
                                                        snap["stages"])
        tele = snap["telemetry"]
        assert tele["tracing"] is True and tele["dropped"] == 0
        assert tele["spans"] == len(eng.tracer) > 0
        assert isinstance(snap["watchdog_events"], list)
        eng.close()

    def test_chrome_export_of_daemon_run_is_loadable(self, tmp_path):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0,
                          trace=True)
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        eng.close()
        path = tmp_path / "daemon_trace.json"
        eng.tracer.export(path)
        doc = json.loads(path.read_text())
        events = doc["traceEvents"]
        assert doc["otherData"]["dropped_spans"] == 0
        assert all(e["ph"] in ("X", "i", "C", "M") for e in events)
        tracks = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert "requests" in tracks and "scheduler" in tracks
        assert any(t.startswith("stream-") for t in tracks)
        req = [e for e in events
               if e["ph"] == "X" and e["name"] == "request"]
        assert len(req) == 4
        assert all(e["args"]["outcome"] == "resolved" for e in req)
        # every arg value must already be JSON-scalar after coercion
        for e in events:
            for v in e.get("args", {}).values():
                assert isinstance(v, (int, float, str, bool, type(None)))

    def test_tracer_instance_adopts_engine_clock(self):
        tracer = Tracer(capacity=1024)
        clock = ManualClock(start=5.0)
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0,
                          trace=tracer)
        assert eng.tracer is tracer
        assert tracer.now() == 5.0            # bound to the engine clock
        eng.close()
        with pytest.raises(TypeError):
            MatFnEngine(device="cpu", trace=object())

    def test_tracing_off_by_default_and_costless(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0)
        eng.start()
        assert eng.tracer is NULL_TRACER
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(4)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        # real traffic served; nothing recorded anywhere
        assert len(eng.tracer) == 0 and eng.tracer.dropped == 0
        snap = eng.stats()
        assert snap["telemetry"] == {"tracing": False, "spans": 0,
                                     "dropped": 0}
        # histogram metrics still work with tracing off — they are
        # independent pieces
        assert snap["lanes"]["bulk"]["p95_ms"] == 0.0
        eng.close()
