"""The port's per-route execution streams: deterministic multi-stream
concurrency — the reference's tests/test_matfn_streams.py on
``device="cpu"``, zero-sleep style (ManualClock deadlines + Event-gated
executors; real-time waits only as bounded backstops on events):

  * an in-flight ``chain`` bucket must NOT block a due ``torch`` flush or a
    priority-lane bypass — proven by wedging one stream on an Event and
    resolving work on the others while it is still wedged;
  * stream-count invariance: the SAME random (op, n, dtype, power, lane)
    trace served with ``streams`` in {1, 2, 4} produces bit-identical
    results and EXACTLY equal counter accounting (shed pattern, retries,
    buckets, compiles, triggers), every result within ``error_budget`` of
    the per-matrix call — streams change the schedule, never the math;
  * the Strassen (``fastmm``) route on a stream of its own: a wedged
    fastmm bucket blocks neither torch nor chain, and its answers are
    stream-count invariant (within its ``error_budget`` of the float64
    power, to the bit across stream counts);
  * exactly-once resolution: racing producers across concurrently
    executing streams never double-resolve a future (counted);
  * ``warm()`` prepares each route's callables ON its stream and the first
    post-warm traffic pays zero builds;
  * ``close(drain=False)`` with buckets wedged in flight on TWO streams
    cancels every pending future loudly and returns the process to its
    thread baseline; a scheduler crash with the same two-stream wedge
    poisons every future with a typed error while the streams survive to
    be joined by ``close()``.
"""

import collections
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from _torch_parity import (assert_bucket_answer as _check, matpow_mults,
                           per_matrix)

from repro_torch.kernels import autotune, error_budget
from repro_torch.serve.admission import AdmissionControl
from repro_torch.serve.matfn import (BucketExecutionError, MatFnEngine,
                                     MatFnFuture)
from repro_torch.serve.scheduler import FillOrDeadline, ManualClock
from repro_torch.serve.streams import (ExecutionStreams, StreamCrashed,
                                       StreamPool)

pytestmark = pytest.mark.timeout(120)

TIMEOUT = 30.0   # real-time backstop on event waits; never load-bearing

#: torch/chain crossover used throughout: n <= 64 -> torch, bigger ->
#: chain (sharded needs a mesh, so its stream stays idle in these tests).
THRESHOLDS = (64, 1 << 30)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def _mat(n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((n, n)) * 0.4 / np.sqrt(n),
                        dtype=dtype)


def _ref(op, a, power):
    """The port's per-matrix answer (see ``_torch_parity.per_matrix``)."""
    return per_matrix(op, a, power)


def _engine(clock=None, **kw):
    kw.setdefault("thresholds", THRESHOLDS)
    kw.setdefault("max_batch", 16)
    return MatFnEngine(device="cpu", clock=clock, **kw)


def _wait_queued(eng, count, what="buckets queued"):
    """Block until exactly ``count`` buckets wait in the stream queues: an
    event wait on the pool's condition (``dispatch`` notifies it), bounded
    by ``TIMEOUT`` — no sleep."""
    pool = eng._pool
    with pool._cv:
        assert pool._cv.wait_for(
            lambda: sum(len(q) for q in pool._queues) == count, TIMEOUT), \
            f"{what} never reached"


class _Wedge:
    """Event-gated executor wedge: buckets whose n falls in ``ns`` block
    on ``gate`` after signalling ``entered``; everything else runs the
    real chunk core. The canonical way to hold ONE stream mid-execution
    while asserting what the others do."""

    def __init__(self, eng, ns):
        self.real = eng._run_chunk
        self.ns = set(ns)
        self.entered = threading.Event()
        self.entered_n = {n: threading.Event() for n in self.ns}
        self.gate = threading.Event()
        eng._run_chunk = self

    def __call__(self, op, n, dtype, power, operands):
        if n in self.ns:
            self.entered.set()
            self.entered_n[n].set()
            assert self.gate.wait(TIMEOUT), "wedge gate never released"
        return self.real(op, n, dtype, power, operands)


class TestExecutionStreamsConfig:
    def test_default_one_stream_per_route(self):
        cfg = ExecutionStreams()
        assert cfg.streams == 5
        assert cfg.routes == ("torch", "chain", "sharded", "fastmm",
                              "evolve")
        assert [cfg.stream_for(r) for r in cfg.routes] == [0, 1, 2, 3, 4]
        assert cfg.routes_for(1) == ("chain",)
        assert "chain" in cfg.label(1)
        assert "fastmm" in cfg.label(3)
        assert "evolve" in cfg.label(4)

    def test_streams_fold_onto_workers(self):
        cfg = ExecutionStreams(streams=2)
        # torch, sharded, and the cheap markov evolve route share stream 0;
        # the two heavy chain routes (chain and fastmm) share stream 1.
        assert cfg.stream_for("torch") == 0
        assert cfg.stream_for("chain") == 1
        assert cfg.stream_for("sharded") == 0
        assert cfg.stream_for("fastmm") == 1
        assert cfg.stream_for("evolve") == 0
        assert cfg.routes_for(0) == ("torch", "sharded", "evolve")
        assert cfg.routes_for(1) == ("chain", "fastmm")
        one = ExecutionStreams(streams=1)
        assert {one.stream_for(r) for r in one.routes} == {0}
        # extra streams beyond the routes idle
        wide = ExecutionStreams(streams=7)
        assert wide.routes_for(6) == ()
        assert "idle" in wide.label(6)

    @pytest.mark.parametrize("bad", [0, -1, True, 1.5, "2"])
    def test_rejects_bad_stream_counts(self, bad):
        with pytest.raises((ValueError, TypeError)):
            ExecutionStreams(streams=bad)

    def test_rejects_bad_routes(self):
        with pytest.raises(ValueError):
            ExecutionStreams(routes=())
        with pytest.raises(ValueError):
            ExecutionStreams(routes=("torch", "torch"))
        with pytest.raises(ValueError, match="unknown route"):
            ExecutionStreams().stream_for("gpu")

    def test_engine_requires_route_coverage(self, tmp_cache):
        with pytest.raises(ValueError, match="missing"):
            MatFnEngine(device="cpu", streams=ExecutionStreams(routes=("torch", "chain")))
        # three dense routes but no fastmm/evolve: still not enough
        with pytest.raises(ValueError, match="missing"):
            MatFnEngine(device="cpu", streams=ExecutionStreams(
                routes=("torch", "chain", "sharded")))

    def test_dispatch_to_crashed_stream_raises(self):
        entered, gate = threading.Event(), threading.Event()

        def boom(bucket, trigger, stream):
            entered.set()
            assert gate.wait(TIMEOUT)
            raise KeyboardInterrupt("stream dies")

        crashes = []
        pool = StreamPool(ExecutionStreams(streams=1),
                          boom,
                          on_crash=lambda i, items, exc:
                          crashes.append((i, items, exc))).start()
        pool.dispatch("torch", "bucket-a", "fill")
        assert entered.wait(TIMEOUT)
        gate.set()
        # the worker thread dies after the crash handler runs
        assert pool.join(TIMEOUT)
        assert len(crashes) == 1 and crashes[0][0] == 0
        with pytest.raises(StreamCrashed) as ei:
            pool.dispatch("torch", "bucket-b", "fill")
        assert ei.value.stream == 0
        assert isinstance(ei.value.__cause__, KeyboardInterrupt)


class TestStreamOverlap:
    def test_wedged_chain_stream_does_not_block_xla(self, tmp_cache):
        """The tentpole property: a chain bucket wedged IN FLIGHT, a due
        torch bucket still flushes (different stream) — deterministic, no
        sleeps."""
        clock = ManualClock()
        eng = _engine(clock)
        wedge = _Wedge(eng, ns={96})
        with eng:
            fut_chain = eng.submit("matpow", _mat(96), power=3)
            clock.advance(10.0)            # chain deadline fires
            assert wedge.entered.wait(TIMEOUT)
            # chain stream is now wedged mid-execution; torch work must
            # still flow end to end
            a = _mat(16, seed=1)
            fut_xla = eng.submit("matpow", a, power=3)
            clock.advance(10.0)
            got = fut_xla.result(timeout=TIMEOUT)
            _check(got, _ref("matpow", a, 3))
            assert not fut_chain.done()
            snap = eng.stats()
            assert snap["peak_concurrent_streams"] >= 2
            rows = {r["label"]: r for r in snap["streams"]}
            assert any(r["busy"] for r in rows.values())
            wedge.gate.set()
            fut_chain.result(timeout=TIMEOUT)

    def test_priority_bypass_dispatches_without_scheduler_poll(
            self, tmp_cache):
        """bypass_direct: a latency request above bypass_n reaches its
        stream straight from submit — it resolves with the clock never
        advanced and the scheduler never polled."""
        clock = ManualClock()
        eng = _engine(clock, admission=AdmissionControl(bypass_n=1))
        wedge = _Wedge(eng, ns={96})
        with eng:
            fut_chain = eng.submit("matpow", _mat(96), power=3)
            clock.advance(10.0)
            assert wedge.entered.wait(TIMEOUT)
            a = _mat(8, seed=2)
            fut = eng.submit("matpow", a, power=2, priority="latency")
            # no clock.advance: the scheduler is still asleep, the chain
            # stream is still wedged — only the direct hand-off can serve
            got = fut.result(timeout=TIMEOUT)
            _check(got, _ref("matpow", a, 2))
            assert eng.stats()["flush_triggers"]["priority"] == 1
            wedge.gate.set()
            fut_chain.result(timeout=TIMEOUT)

    def test_bypass_direct_off_restores_mark_due(self, tmp_cache):
        """bypass_direct=False: the bypass bucket is only MARKED due —
        nothing executes until the scheduler polls (the pre-streams
        contract, kept reachable for single-dispatch-thread deployments)."""
        clock = ManualClock()
        eng = _engine(clock, admission=AdmissionControl(
            bypass_n=1, bypass_direct=False))
        with eng:
            fut = eng.submit("matpow", _mat(8), power=2, priority="latency")
            eng.settle(timeout=TIMEOUT)    # scheduler polls the forced bucket
            fut.result(timeout=TIMEOUT)
            assert eng.stats()["flush_triggers"]["priority"] == 1

    def test_latency_bucket_jumps_stream_queue(self, tmp_cache):
        """Priority insertion on the stream: with the torch stream wedged,
        a latency bucket dispatched AFTER two queued bulk buckets runs
        before them."""
        clock = ManualClock()
        eng = _engine(clock, admission=AdmissionControl(bypass_n=1 << 30))
        order = []
        real = eng._run_chunk
        entered, gate = threading.Event(), threading.Event()

        def tracking(op, n, dtype, power, operands):
            if n == 8:
                entered.set()
                assert gate.wait(TIMEOUT)
            order.append(n)
            return real(op, n, dtype, power, operands)

        eng._run_chunk = tracking

        with eng:
            f0 = eng.submit("matpow", _mat(8), power=2)
            clock.advance(10.0)            # wedge the torch stream on n=8
            assert entered.wait(TIMEOUT)
            f1 = eng.submit("matpow", _mat(16), power=2)
            f2 = eng.submit("matpow", _mat(24), power=2)
            clock.advance(10.0)            # both bulk buckets queue up
            _wait_queued(eng, 2, "bulk buckets queued")
            f3 = eng.submit("matpow", _mat(32), power=2,
                            priority="latency")
            clock.advance(10.0)            # latency bucket dispatched LAST
            _wait_queued(eng, 3, "latency bucket queued")
            gate.set()
            for f in (f0, f1, f2, f3):
                f.result(timeout=TIMEOUT)
            # wedged first; then the latency bucket — queued last but
            # inserted ahead of both waiting bulk buckets
            assert order == [8, 32, 16, 24]


class TestFastmmStream:
    """The Strassen route (``fastmm``, n above the crossover) gets the
    isolation of the others: a wedged fastmm bucket must not block the
    torch or chain flushes, and fastmm traffic is stream-count invariant —
    its answers are held to the float64 power under ``error_budget(levels=
    ...)``, but across stream counts the same callable on the same inputs
    gives the same bits. Here n <= 8 takes torch, n = 16 the chain and
    n >= 40 fastmm (a cache whose crossover is 16, two levels)."""

    THRESHOLDS = (8, 1 << 30)

    def test_wedged_fastmm_does_not_block_xla_or_chain(self, tmp_cache):
        """With the fastmm stream wedged mid-execution, torch and chain
        traffic still flow end to end; the fastmm request is then served."""
        autotune.record_fastmm(16, 2, backend="cpu")
        clock = ManualClock()
        eng = _engine(clock, thresholds=self.THRESHOLDS)
        wedge = _Wedge(eng, ns={48})
        with eng:
            a48 = _mat(48, seed=5)
            fut_fast = eng.submit("matpow", a48, power=3)
            clock.advance(10.0)            # the fastmm deadline fires
            assert wedge.entered.wait(TIMEOUT)
            a8, a16 = _mat(8, seed=6), _mat(16, seed=7)
            fut_xla = eng.submit("matpow", a8, power=3)
            fut_chain = eng.submit("matpow", a16, power=3)
            clock.advance(10.0)
            _check(fut_xla.result(timeout=TIMEOUT), _ref("matpow", a8, 3))
            _check(fut_chain.result(timeout=TIMEOUT), _ref("matpow", a16, 3))
            assert not fut_fast.done()
            snap = eng.stats()
            # the wedge holds the fastmm bucket before the chunk core, so
            # only the two dense routes have counted yet
            assert snap["routes"] == {"torch": 1, "chain": 1, "sharded": 0,
                                      "fastmm": 0, "evolve": 0}
            assert snap["peak_concurrent_streams"] >= 2
            wedge.gate.set()
            got = fut_fast.result(timeout=TIMEOUT)
            assert eng.stats()["routes"]["fastmm"] == 1
        # the wedged route's own answer: the Strassen budget, not bits
        rtol, atol = error_budget(torch.float32, levels=2, n=48,
                                  mults=matpow_mults(3))
        np.testing.assert_allclose(
            got.double().numpy(),
            np.linalg.matrix_power(a48.double().numpy(), 3),
            rtol=rtol, atol=atol)

    def _serve(self, trace, n_streams):
        clock = ManualClock()
        eng = _engine(clock, thresholds=self.THRESHOLDS,
                      streams=ExecutionStreams(streams=n_streams))
        with eng:
            futs = [eng.submit(op, a, power=p) for op, a, p in trace]
            clock.advance(10.0)
            eng.settle(timeout=TIMEOUT)
            outcomes = [f.result(timeout=TIMEOUT) for f in futs]
            snap = eng.stats()
        return outcomes, snap

    def test_streams_1_2_4_invariant_within_tolerance_gate(self, tmp_cache):
        """The same trace with fastmm-sized requests mixed in, at streams
        in {1, 2, 4}: every answer within its route's budget of the
        float64 power, the accounting equal, the bits equal."""
        autotune.record_fastmm(16, 2, backend="cpu")
        rng = np.random.default_rng(11)
        sizes = [8, 16, 48]
        trace = [("matpow", _mat(sizes[int(rng.integers(0, 3))],
                                 seed=2000 + i), int(rng.integers(1, 4)))
                 for i in range(12)]
        runs = {k: self._serve(trace, k) for k in (1, 2, 4)}
        base_outs, base_snap = runs[1]
        assert base_snap["routes"]["fastmm"] > 0
        for out, (op, a, p) in zip(base_outs, trace):
            n = a.shape[0]
            rtol, atol = error_budget(torch.float32,
                                      levels=2 if n > 16 else 0, n=n,
                                      mults=matpow_mults(p))
            np.testing.assert_allclose(
                out.double().numpy(),
                np.linalg.matrix_power(a.double().numpy(), p),
                rtol=rtol, atol=atol)
        for k in (2, 4):
            outs, snap = runs[k]
            assert snap["routes"] == base_snap["routes"]
            assert snap["requests"] == base_snap["requests"]
            for i, (o, b) in enumerate(zip(outs, base_outs)):
                assert torch.equal(o, b), \
                    f"trace diverged at streams={k}, request {i}"


class TestStreamCountInvariance:
    """The property test: streams change the schedule, never the math or
    the accounting. One random trace, served at streams in {1, 2, 4},
    must produce the same shed pattern, the same counters, and
    bit-identical results — all equal to the per-matrix oracle."""

    #: stats() keys that must be EXACTLY equal across stream counts
    #: (wall-time-dependent keys — stragglers, latencies, per-stream
    #: rows — legitimately differ).
    INVARIANT = ("requests", "buckets", "compiles", "cache_hits",
                 "padded_slots", "retries", "routes", "flush_triggers")
    LANE_INVARIANT = ("submitted", "shed", "retried", "flushed",
                      "peak_depth", "queue_depth")

    @staticmethod
    def _trace(seed, n_requests=40):
        rng = np.random.default_rng(seed)
        trace = []
        for i in range(n_requests):
            op = rng.choice(["matpow", "expm"])
            n = int(rng.choice([8, 16, 96]))
            power = int(rng.integers(1, 4)) if op == "matpow" else 1
            lane = "latency" if rng.random() < 0.3 else "bulk"
            trace.append((op, _mat(n, seed=1000 + i), power, lane))
        # one unique traffic class whose FIRST execution will be failed
        # deterministically: exact retry accounting must be stream-count
        # invariant too. Front of the trace — the queue is empty there,
        # so no admission capacity can shed it.
        trace.insert(0, ("expm", _mat(40, seed=999), 1, "bulk"))
        return trace

    @staticmethod
    def _serve(trace, n_streams, seed):
        clock = ManualClock()
        eng = _engine(clock,
                      streams=ExecutionStreams(streams=n_streams),
                      admission=AdmissionControl(
                          capacity={"bulk": 12, "latency": 6},
                          bypass_n=96),
                      retries=1)
        real = eng._run_chunk
        fail_lock = threading.Lock()
        failed = []

        def failing(op, n, dtype, power, operands):
            if n == 40:
                with fail_lock:
                    first = not failed
                    failed.append(1)
                if first:
                    raise ValueError("deterministic first-call failure")
            return real(op, n, dtype, power, operands)

        eng._run_chunk = failing
        outcomes = []
        with eng:
            futs = []
            for op, a, power, lane in trace:
                try:
                    futs.append(eng.submit(op, a, power=power,
                                           priority=lane))
                except Exception as exc:   # ShedError — part of the record
                    futs.append(exc)
            clock.advance(10.0)            # every deadline fires
            eng.settle(timeout=TIMEOUT)
            for f in futs:
                if isinstance(f, MatFnFuture):
                    outcomes.append(("ok", f.result(timeout=TIMEOUT)))
                else:
                    outcomes.append(("shed", type(f).__name__))
            snap = eng.stats()
        inv = {k: snap[k] for k in TestStreamCountInvariance.INVARIANT}
        inv["lanes"] = {
            lane: {k: row[k]
                   for k in TestStreamCountInvariance.LANE_INVARIANT}
            for lane, row in snap["lanes"].items()}
        return outcomes, inv, snap

    def test_streams_1_2_4_bit_identical(self, tmp_cache):
        trace = self._trace(seed=7)
        # guard: no (key, lane) class may FILL during the submit phase —
        # bucket membership would then race the scheduler and the
        # property below would be vacuous
        counts = collections.Counter(
            ((op, a.shape[0], power), lane) for op, a, power, lane in trace)
        assert max(counts.values()) < 16, "trace would fill a bucket"

        runs = {k: self._serve(trace, k, seed=7) for k in (1, 2, 4)}
        base_out, base_inv, _ = runs[1]
        assert base_inv["retries"] == 1          # the injected failure
        assert any(kind == "shed" for kind, _ in base_out)
        assert any(kind == "ok" for kind, _ in base_out)

        # every survivor within error_budget of the per-matrix call (the
        # port does not claim bucket-vs-per-matrix bits: see
        # _torch_parity.assert_bucket_answer)
        for (kind, got), (op, a, power, _lane) in zip(base_out, trace):
            if kind == "ok":
                _check(got, _ref(op, a, power))

        for k in (2, 4):
            out, inv, _ = runs[k]
            assert inv == base_inv, f"accounting diverged at streams={k}"
            for i, ((kind, val), (bkind, bval)) in enumerate(
                    zip(out, base_out)):
                assert kind == bkind, \
                    f"shed pattern diverged at streams={k}, request {i}"
                if kind == "ok":
                    assert torch.equal(val, bval), \
                        f"result diverged at streams={k}, request {i}"

    def test_streams_4_used_both_routes(self, tmp_cache):
        _, _, snap = self._serve(self._trace(seed=7), 4, seed=7)
        per_stream = {r["label"]: r["executed"] for r in snap["streams"]}
        assert sum(per_stream.values()) == snap["buckets"]
        busy = [label for label, n in per_stream.items() if n > 0]
        assert any("torch" in b for b in busy)
        assert any("chain" in b for b in busy)


class TestExactlyOnceAcrossStreams:
    def test_racing_producers_every_future_resolves_once(
            self, tmp_cache, monkeypatch):
        """3 producers x mixed routes on real time: count every
        resolution ATTEMPT — across concurrent streams each future must
        see exactly one, not merely survive doubles via
        InvalidStateError."""
        attempts = collections.Counter()
        lock = threading.Lock()
        orig_res = MatFnFuture.set_result
        orig_exc = MatFnFuture.set_exception

        def counting_result(self, value):
            with lock:
                attempts[id(self)] += 1
            return orig_res(self, value)

        def counting_exception(self, exc):
            with lock:
                attempts[id(self)] += 1
            return orig_exc(self, exc)

        monkeypatch.setattr(MatFnFuture, "set_result", counting_result)
        monkeypatch.setattr(MatFnFuture, "set_exception",
                            counting_exception)

        eng = _engine(max_delay_ms=2.0, max_batch=8)
        futs, futs_lock = [], threading.Lock()

        def producer(pid):
            rng = np.random.default_rng(pid)
            for i in range(12):
                n = int(rng.choice([8, 16, 96]))
                f = eng.submit("matpow", _mat(n, seed=pid * 100 + i),
                               power=2,
                               priority="latency" if i % 4 == 0 else "bulk")
                with futs_lock:
                    futs.append(f)

        with eng:
            threads = [threading.Thread(target=producer, args=(p,))
                       for p in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            for f in futs:
                f.result(timeout=TIMEOUT)

        assert len(futs) == 36
        counted = [attempts[id(f)] for f in futs]
        assert counted == [1] * 36, "a future saw multiple resolutions"


class TestWarmOnStreams:
    def test_warm_runs_on_route_streams(self, tmp_cache):
        clock = ManualClock()
        eng = _engine(clock)
        names = []
        real = eng._run_chunk

        def recording(op, n, dtype, power, operands):
            names.append((n, threading.current_thread().name))
            return real(op, n, dtype, power, operands)

        eng._run_chunk = recording
        with eng:
            chunks = eng.warm("matpow", 16, power=3, batches=(1, 2))
            chunks += eng.warm("matpow", 96, power=3, batches=(1,))
            assert chunks == 3
            for n, thread_name in names:
                route = "torch" if n <= 64 else "chain"
                assert route in thread_name, \
                    f"warm chunk n={n} ran on {thread_name!r}"

    def test_zero_compiles_after_warm(self, tmp_cache):
        clock = ManualClock()
        eng = _engine(clock)
        with eng:
            eng.warm("matpow", 16, power=3, batches=(1, 2))
            eng.warm("matpow", 96, power=3, batches=(1,))
            compiled = eng.stats()["compiles"]
            assert compiled > 0
            futs = [eng.submit("matpow", _mat(16, seed=i), power=3)
                    for i in range(2)]
            futs.append(eng.submit("matpow", _mat(96, seed=9), power=3))
            clock.advance(10.0)
            eng.settle(timeout=TIMEOUT)
            for f in futs:
                f.result(timeout=TIMEOUT)
            assert eng.stats()["compiles"] == compiled, \
                "post-warm traffic paid a compile"


class TestCloseAndCrashMultiStream:
    def _wedge_two_streams(self, eng, clock):
        """Dispatch 4 buckets: one wedged EXECUTING on each of the torch
        and chain streams, one more QUEUED behind each wedge. Returns
        (futures, wedge)."""
        wedge = _Wedge(eng, ns={8, 96})
        eng.start()
        f_exec_xla = eng.submit("matpow", _mat(8), power=2)
        f_exec_chn = eng.submit("matpow", _mat(96), power=2)
        clock.advance(10.0)
        assert wedge.entered.wait(TIMEOUT)
        # the queued buckets below are keyed differently, so per-stream
        # FIFO keeps them behind the wedges whichever order those landed
        f_q_xla = eng.submit("matpow", _mat(16), power=2)
        f_q_chn = eng.submit("matpow", _mat(128), power=2)
        clock.advance(10.0)
        # known-stable state to act on: both streams wedged EXECUTING,
        # one bucket queued behind each
        for n in (8, 96):
            assert wedge.entered_n[n].wait(TIMEOUT)
        _wait_queued(eng, 2, "two wedged streams with queued buckets")
        assert sum(1 for r in eng.stats()["streams"] if r["busy"]) == 2
        return [f_exec_xla, f_exec_chn, f_q_xla, f_q_chn], wedge

    def test_close_nodrain_cancels_across_two_wedged_streams(
            self, tmp_cache):
        # warm the torch backend first so anything it starts lazily does
        # not skew the daemon-thread baseline below
        _ref("matpow", _mat(128), 2)
        baseline = threading.active_count()
        clock = ManualClock()
        eng = _engine(clock)
        futs, wedge = self._wedge_two_streams(eng, clock)

        closed = threading.Event()

        def closer():
            eng.close(drain=False)
            closed.set()

        t = threading.Thread(target=closer)
        t.start()
        # every pending future is poisoned BEFORE close blocks on the
        # wedged streams: clients unblock immediately
        for f in futs:
            with pytest.raises(CancelledError):
                f.result(timeout=TIMEOUT)
        assert not closed.is_set()
        wedge.gate.set()
        t.join(TIMEOUT)
        assert closed.is_set()
        with pytest.raises(RuntimeError):
            eng.submit("matpow", _mat(8), power=2)
        # queued buckets were cancelled off their streams, never run:
        # each stream executed exactly its one wedged bucket
        executed = {r["label"]: r["executed"]
                    for r in eng.stats()["streams"] if r["executed"]}
        assert all(n == 1 for n in executed.values())
        assert threading.active_count() == baseline, \
            "daemon threads leaked past close()"

    def test_scheduler_crash_poisons_across_two_wedged_streams(
            self, tmp_cache):
        _ref("matpow", _mat(128), 2)
        baseline = threading.active_count()

        class Exploding(FillOrDeadline):
            explode = False

            def due(self, view, now, max_batch):
                if self.explode:
                    raise RuntimeError("policy exploded")
                return super().due(view, now, max_batch)

        policy = Exploding()
        clock = ManualClock()
        eng = _engine(clock, policy=policy)
        futs, wedge = self._wedge_two_streams(eng, clock)

        # crash the scheduler on its next poll, with a fresh open bucket
        # pending too
        policy.explode = True
        f_open = eng.submit("matpow", _mat(24), power=2)
        for f in futs + [f_open]:
            exc = f.exception(timeout=TIMEOUT)
            assert isinstance(exc, BucketExecutionError)
            assert "policy exploded" in str(exc.__cause__)
        with pytest.raises(RuntimeError, match="crashed"):
            eng.submit("matpow", _mat(8), power=2)
        # the streams themselves survived the scheduler's death; close()
        # joins them back to the thread baseline
        wedge.gate.set()
        eng.close(timeout=TIMEOUT)
        assert threading.active_count() == baseline, \
            "daemon threads leaked past close()"
