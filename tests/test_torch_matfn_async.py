"""The port's continuous-batching daemon: concurrency, determinism, error
routing — the reference's tests/test_matfn_async.py on ``device="cpu"``.

Covers the async-serving acceptance criteria:
  * N producer threads submitting mixed (op, n, dtype, power) requests —
    every future resolves exactly once, answers bit-identical to the
    synchronous engine and within ``error_budget`` of per-matrix calls
    (``_torch_parity.assert_bucket_answer``), submission racing never
    corrupts bucketing;
  * deadline behavior driven by an injectable ``ManualClock`` — flushes
    happen on fill OR deadline, never before, with no sleep-based timing
    anywhere (real-time waits only as bounded backstops on events);
  * ``close()`` drains every pending bucket (no dropped futures),
    ``drain=False`` cancels them loudly — in-flight buckets included;
  * executor failures route into the affected bucket's futures as
    ``BucketExecutionError`` (bucket key in the message, original exception
    chained) and leave the scheduler serving other buckets — the
    poisoned-dtype regression;
  * admission control: bounded per-lane queues with exact shed accounting
    (ManualClock overflow units AND 6 racing producers), reject-newest vs
    reject-oldest vs deadline-aware victim selection, the latency lane's
    SLO cap and priority bypass, ``kick`` on an empty class as a no-op,
    and the ``stats()`` snapshot schema;
  * fault wiring: transient executor failures self-heal through bounded
    retries (poisoned cached executables are evicted and re-resolved),
    persistent ones exhaust into ``BucketExecutionError``, and straggling
    flushes are counted + logged without evicting healthy executables;
  * dispatch memoization invalidates on autotune cache generation: a
    ``record_dispatch_thresholds`` / ``record_bucket_deadline`` mid-process
    reroutes the SAME engine (no restart);
  * flush policies (fill-or-deadline, adaptive) as pure units.
"""

import threading

import numpy as np
import pytest
import torch

from _torch_parity import assert_bucket_answer as _check, per_matrix
from repro_torch.kernels import autotune
from repro_torch.runtime.fault import StragglerEvent
from repro_torch.serve.admission import (AdmissionControl, DeadlineAware,
                                   RejectNewest, RejectOldest, ShedError)
from repro_torch.serve.matfn import (BucketExecutionError, MatFnEngine,
                               MatFnFuture)
from repro_torch.serve.scheduler import (AdaptiveDeadline, BucketView,
                                   FillOrDeadline, ManualClock, SystemClock)

# Concurrency suite: a wedged daemon/stream thread must FAIL the test, not
# hang the run. The mark is enforced only where pytest-timeout is
# installed; every wait below is bounded on its own (TIMEOUT).
pytestmark = pytest.mark.timeout(120)

TIMEOUT = 30.0   # real-time backstop on event waits; never load-bearing


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


class TestMatFnFuture:
    def test_set_result_and_done(self):
        fut = MatFnFuture(("matpow", 8, "float32", 2))
        assert not fut.done()
        fut.set_result(42)
        assert fut.done() and fut.result() == 42
        assert fut.exception() is None
        assert fut.resolved_at is not None

    def test_result_timeout(self):
        # the futures idiom must work on 3.10 too, where
        # concurrent.futures.TimeoutError is NOT yet the builtin alias
        from concurrent.futures import TimeoutError as FutureTimeoutError
        with pytest.raises(FutureTimeoutError):
            MatFnFuture().result(timeout=0.01)
        with pytest.raises(FutureTimeoutError):
            MatFnFuture().exception(timeout=0.01)

    def test_no_double_resolution(self):
        from concurrent.futures import InvalidStateError
        fut = MatFnFuture()
        fut.set_result(1)
        with pytest.raises(InvalidStateError):
            fut.set_result(2)
        with pytest.raises(InvalidStateError):
            fut.set_exception(RuntimeError("late"))
        assert fut.result() == 1

    def test_exception_propagates(self):
        fut = MatFnFuture()
        fut.set_exception(ValueError("boom"))
        with pytest.raises(ValueError, match="boom"):
            fut.result()
        assert isinstance(fut.exception(), ValueError)


class TestPolicies:
    def _view(self, size, first_ts=10.0, max_delay_s=0.002):
        return BucketView(("matpow", 8, "float32", 2), size, first_ts,
                          max_delay_s)

    def test_fill_or_deadline(self):
        p = FillOrDeadline()
        v = self._view(3)
        assert not p.due(v, now=10.001, max_batch=8)       # neither
        assert p.due(self._view(8), now=10.0, max_batch=8)  # fill
        assert p.due(v, now=10.002, max_batch=8)           # deadline
        assert p.deadline(v, max_batch=8) == pytest.approx(10.002)

    def test_adaptive_no_history_matches_static(self):
        p = AdaptiveDeadline()
        v = self._view(2)
        assert p.deadline(v, max_batch=8) == \
            FillOrDeadline().deadline(v, max_batch=8)

    def test_adaptive_shrinks_with_hot_traffic(self):
        p = AdaptiveDeadline(min_delay_s=1e-5)
        v = self._view(1, max_delay_s=0.1)
        for i in range(20):                  # 100 us inter-arrival gaps
            p.observe(v, now=10.0 + i * 1e-4)
        # expected fill time ~ gap * max_batch = 0.8 ms << tuned 100 ms
        delay = p.effective_delay(v, max_batch=8)
        assert 1e-5 <= delay <= 0.002
        assert p.due(v, now=v.first_ts + 0.005, max_batch=8)

    def test_adaptive_clamps_to_tuned_max_on_sparse_traffic(self):
        p = AdaptiveDeadline()
        v = self._view(1, max_delay_s=0.002)
        for i in range(5):                   # 10 s gaps: bucket never fills
            p.observe(v, now=10.0 + i * 10.0)
        assert p.effective_delay(v, max_batch=8) == v.max_delay_s

    def test_adaptive_rejections(self):
        with pytest.raises(ValueError):
            AdaptiveDeadline(smoothing=0.0)
        with pytest.raises(ValueError):
            AdaptiveDeadline(min_delay_s=0.0)

    def test_manual_clock(self):
        clock = ManualClock(start=5.0)
        assert clock.now() == 5.0
        assert clock.advance(1.5) == 6.5
        with pytest.raises(ValueError):
            clock.advance(-1.0)
        assert isinstance(SystemClock().now(), float)


class TestDaemonLifecycle:
    def test_submit_returns_future_immediately(self):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0) as eng:
            fut = eng.submit("matpow", _mat(8), power=3)
            assert isinstance(fut, MatFnFuture)
            assert fut.bucket_key == ("matpow", 8, "float32", 3)
            eng.settle(TIMEOUT)
            # Manual clock: no deadline can pass, bucket can't fill -> the
            # future CANNOT resolve yet (deterministic, not a race).
            assert not fut.done()
        assert fut.done()                     # close() drained it

    def test_fill_triggers_flush_without_time_passing(self):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0) as eng:
            mats = [_mat(8, seed=i) for i in range(4)]
            futs = [eng.submit("matpow", m, power=7) for m in mats]
            res = [f.result(timeout=TIMEOUT) for f in futs]
            assert eng.stats["flush_triggers"]["fill"] == 1
            for m, r in zip(mats, res):
                _check(r, _ref("matpow", m, 7))

    def test_deadline_triggers_flush_on_clock_advance(self):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0) as eng:
            fut = eng.submit("matpow", _mat(8), power=3)
            clock.advance(0.005)              # 5 ms < 10 ms: NOT due
            eng.settle(TIMEOUT)
            assert not fut.done()
            assert eng.stats["flush_triggers"]["deadline"] == 0
            clock.advance(0.006)              # 11 ms total: due
            fut.result(timeout=TIMEOUT)
            assert eng.stats["flush_triggers"]["deadline"] == 1

    def test_deadline_anchored_to_oldest_member(self):
        """Stragglers must not push the oldest request past its deadline."""
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0) as eng:
            first = eng.submit("matpow", _mat(8, seed=0), power=3)
            clock.advance(0.008)
            eng.settle(TIMEOUT)
            eng.submit("matpow", _mat(8, seed=1), power=3)  # same bucket
            clock.advance(0.003)              # 11 ms after FIRST arrival
            first.result(timeout=TIMEOUT)
            assert eng.stats["flush_triggers"]["deadline"] == 1

    def test_kick_flushes_immediately(self):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0) as eng:
            fut = eng.submit("matpow", _mat(8), power=3)
            eng.kick()
            fut.result(timeout=TIMEOUT)
            assert eng.stats["flush_triggers"]["kick"] == 1

    def test_targeted_kick_leaves_bystander_buckets_batching(self):
        """kick(key) must not force-flush other classes' half-full
        buckets (the convenience API uses it per-future)."""
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0) as eng:
            bystander = eng.submit("matpow", _mat(16), power=3)
            urgent = eng.submit("matpow", _mat(8), power=3)
            eng.kick(urgent.bucket_key)
            urgent.result(timeout=TIMEOUT)
            eng.settle(TIMEOUT)
            assert not bystander.done()       # still batching
            assert eng.stats["flush_triggers"]["kick"] == 1
            _check(eng.matpow(_mat(12), 5),   # per-future kick
                   _ref("matpow", _mat(12), 5))
            eng.settle(TIMEOUT)
            assert not bystander.done()       # convenience call spared it too

    def test_convenience_api_in_daemon_mode(self):
        a = _mat(8, seed=2)
        with MatFnEngine(device="cpu", max_batch=8, clock=ManualClock(),
                         max_delay_ms=10.0) as eng:
            _check(eng.matpow(a, 7), _ref("matpow", a, 7))
            _check(eng.expm(a), _ref("expm", a, 1))

    def test_close_drains_pending_partial_buckets(self):
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0)
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(3)]
        futs.append(eng.submit("expm", _mat(12, seed=9)))
        eng.close()
        assert all(f.done() for f in futs)
        assert eng.stats["flush_triggers"]["drain"] == 2   # two buckets
        for f in futs:
            assert f.exception() is None

    def test_close_timeout_reports_unfinished_drain(self):
        """close(timeout=...) must not claim a completed drain while the
        scheduler is still wedged in an executor."""
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=2, clock=clock, max_delay_ms=10.0)
        gate = threading.Event()
        real = eng._run_chunk

        def slow_chunk(*args, **kwargs):
            gate.wait(TIMEOUT)
            return real(*args, **kwargs)

        eng._run_chunk = slow_chunk
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]         # fills -> scheduler blocks in gate
        with pytest.raises(TimeoutError):
            eng.close(timeout=0.05)
        with pytest.raises(RuntimeError):  # still closed to new submits
            eng.submit("matpow", _mat(8), power=3)
        gate.set()
        eng.close()                        # drain completes cleanly now
        for f in futs:
            assert f.exception() is None

    def test_close_without_drain_cancels(self):
        from concurrent.futures import CancelledError
        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=8, clock=clock, max_delay_ms=10.0)
        eng.start()
        fut = eng.submit("matpow", _mat(8), power=3)
        eng.close(drain=False)
        with pytest.raises(CancelledError):
            fut.result(timeout=TIMEOUT)

    def test_lifecycle_rejections(self):
        eng = MatFnEngine(device="cpu", max_batch=4, clock=ManualClock())
        eng.start()
        assert eng.running
        with pytest.raises(RuntimeError, match="synchronous"):
            eng.flush()                       # daemon owns the queue
        eng.close()
        eng.close()                           # idempotent
        assert not eng.running
        with pytest.raises(RuntimeError):
            eng.submit("matpow", _mat(8), power=3)
        with pytest.raises(RuntimeError):
            eng.start()                       # closed engines don't restart

    def test_start_with_pending_sync_requests_rejected(self):
        eng = MatFnEngine(device="cpu")
        eng.submit("matpow", _mat(8), power=3)
        with pytest.raises(RuntimeError, match="pending"):
            eng.start()

    def test_constructor_rejections(self):
        with pytest.raises(ValueError):
            MatFnEngine(device="cpu", max_delay_ms=0.0)
        with pytest.raises(ValueError):
            MatFnEngine(device="cpu", max_delay_ms=-5.0)

    def test_settle_noop_in_sync_mode(self):
        MatFnEngine(device="cpu").settle(0.1)


class TestConcurrency:
    def test_producer_threads_every_future_resolves_once(self, monkeypatch):
        """N producer threads x mixed (op, n, dtype, power) traffic: every
        future resolves exactly once, bit-identical to per-matrix calls."""
        n_threads, per_thread = 6, 10
        # Deterministic workloads, operands built on the main thread.
        workloads = []
        for t in range(n_threads):
            rng = np.random.default_rng(1000 + t)
            work = []
            for i in range(per_thread):
                n = int(rng.choice((8, 12, 16)))
                dtype = torch.bfloat16 if (t + i) % 3 == 0 else torch.float32
                a = _mat(n, seed=t * 100 + i, dtype=dtype)
                if i % 5 == 4:
                    work.append(("expm", a, 1))
                else:
                    work.append(("matpow", a, int(rng.choice((2, 7)))))
            workloads.append(work)

        resolutions = {}
        res_lock = threading.Lock()
        orig_set_result = MatFnFuture.set_result
        orig_set_exception = MatFnFuture.set_exception

        def counting_result(self, value):
            with res_lock:
                resolutions[id(self)] = resolutions.get(id(self), 0) + 1
            orig_set_result(self, value)

        def counting_exception(self, exc):
            with res_lock:
                resolutions[id(self)] = resolutions.get(id(self), 0) + 1
            orig_set_exception(self, exc)

        monkeypatch.setattr(MatFnFuture, "set_result", counting_result)
        monkeypatch.setattr(MatFnFuture, "set_exception", counting_exception)

        clock = ManualClock()
        eng = MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0)
        eng.start()
        futures = [[] for _ in range(n_threads)]
        barrier = threading.Barrier(n_threads)

        def producer(t):
            barrier.wait(timeout=TIMEOUT)
            for op, a, power in workloads[t]:
                futures[t].append(eng.submit(op, a, power=power))

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
            assert not th.is_alive()
        eng.close()                           # drains the partial buckets

        total = n_threads * per_thread
        all_futs = [f for fs in futures for f in fs]
        assert len(all_futs) == total
        assert eng.stats["requests"] == total
        assert all(f.done() for f in all_futs)
        # exactly-once resolution, across fill flushes AND the drain
        assert sorted(resolutions.values()) == [1] * total
        for t, work in enumerate(workloads):
            for (op, a, power), fut in zip(work, futures[t]):
                got = fut.result()
                _check(got, _ref(op, a, power))

    def test_daemon_matches_synchronous_flush_bitwise(self):
        """Daemon answers == synchronous flush answers, to the bit (same
        callables, same inputs)."""
        rng = np.random.default_rng(7)
        work = []
        for i in range(24):
            n = int(rng.choice((8, 16)))
            op = "expm" if i % 6 == 5 else "matpow"
            work.append((op, _mat(n, seed=i), int(rng.choice((2, 7)))))

        sync = MatFnEngine(device="cpu", max_batch=4)
        for op, a, power in work:
            sync.submit(op, a, power=power)
        want = sync.flush()

        with MatFnEngine(device="cpu", max_batch=4, clock=ManualClock(),
                         max_delay_ms=10.0) as eng:
            futs = [eng.submit(op, a, power=power) for op, a, power in work]
            eng.kick()
            got = [f.result(timeout=TIMEOUT) for f in futs]
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_chunking_over_max_batch(self):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=10.0) as eng:
            mats = [_mat(8, seed=i) for i in range(10)]
            futs = [eng.submit("matpow", m, power=3) for m in mats]
            clock.advance(0.02)
            res = [f.result(timeout=TIMEOUT) for f in futs]
        for m, r in zip(mats, res):
            _check(r, _ref("matpow", m, 3))


class TestErrorRouting:
    def _poisoned_engine(self, poison_dtype="bfloat16", **kwargs):
        eng = MatFnEngine(device="cpu", **kwargs)
        real = eng._executable

        def poisoned(op, route, bpad, n, dtype, power):
            if dtype == poison_dtype:
                raise RuntimeError("poisoned dtype reached the compiler")
            return real(op, route, bpad, n, dtype, power)

        eng._executable = poisoned
        return eng

    def test_poisoned_dtype_routes_into_bucket_futures(self):
        """Regression: executor exceptions must resolve the affected
        bucket's futures (key in message), not vanish on the scheduler
        thread — and the other buckets must keep working."""
        eng = self._poisoned_engine(max_batch=2, clock=ManualClock(),
                                    max_delay_ms=10.0)
        eng.start()
        good = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]
        bad = [eng.submit("matpow", _mat(8, seed=i, dtype=torch.bfloat16),
                          power=3) for i in range(2)]
        for f in good:
            assert f.exception(timeout=TIMEOUT) is None
        for f in bad:
            with pytest.raises(BucketExecutionError) as ei:
                f.result(timeout=TIMEOUT)
            msg = str(ei.value)
            assert "bfloat16" in msg and "matpow" in msg and "n=8" in msg
            assert isinstance(ei.value.__cause__, RuntimeError)
            assert ei.value.key == ("matpow", 8, "bfloat16", 3)
        # The scheduler survived: fresh traffic still answers.
        again = [eng.submit("matpow", _mat(8, seed=9), power=3),
                 eng.submit("matpow", _mat(8, seed=10), power=3)]
        for f in again:
            assert f.exception(timeout=TIMEOUT) is None
        eng.close()

    def test_error_during_drain_still_resolves_futures(self):
        eng = self._poisoned_engine(max_batch=8, clock=ManualClock(),
                                    max_delay_ms=10.0)
        eng.start()
        ok = eng.submit("matpow", _mat(8), power=3)
        poisoned = eng.submit("matpow", _mat(8, dtype=torch.bfloat16), power=3)
        eng.close()                           # drain hits the poison
        assert ok.exception() is None
        assert isinstance(poisoned.exception(), BucketExecutionError)

    def test_scheduler_crash_fails_in_flight_and_open_buckets(self):
        """A crash mid-scan (e.g. a user policy raising) must fail the
        futures of buckets ALREADY POPPED for flushing, not just the ones
        still open — nothing may hang in a dying frame's local."""

        class EvilPolicy(FillOrDeadline):
            def __init__(self):
                self.seen = set()

            def observe(self, view, now):
                self.seen.add(view.key)

            def due(self, view, now, max_batch):
                if len(self.seen) < 2:
                    return False             # wait for both buckets
                if view.key[1] == 8:
                    return True              # n=8 pops first (dict order)
                raise RuntimeError("policy exploded")

        eng = MatFnEngine(device="cpu", max_batch=8, clock=ManualClock(),
                          policy=EvilPolicy())
        eng.start()
        popped = eng.submit("matpow", _mat(8), power=3)
        still_open = eng.submit("matpow", _mat(16), power=3)
        for fut in (popped, still_open):
            exc = fut.exception(timeout=TIMEOUT)
            assert isinstance(exc, BucketExecutionError)
            assert isinstance(exc.__cause__, RuntimeError)
        with pytest.raises(RuntimeError, match="crashed"):
            eng.submit("matpow", _mat(8), power=3)
        eng.close()

    def test_sync_flush_still_raises_on_calling_thread(self):
        """The synchronous path keeps its raise-to-caller contract."""
        eng = self._poisoned_engine(max_batch=4)
        eng.submit("matpow", _mat(8, dtype=torch.bfloat16), power=3)
        with pytest.raises(RuntimeError, match="poisoned"):
            eng.flush()


class TestMidProcessRetuning:
    def test_generation_bumps_on_every_mutation(self, tmp_cache):
        g0 = autotune.cache_generation()
        autotune.record_dispatch_thresholds(32, 2048)
        g1 = autotune.cache_generation()
        assert g1 > g0
        autotune.clear_memory_cache()
        assert autotune.cache_generation() > g1

    def test_thresholds_reroute_same_engine(self, tmp_cache):
        """Regression: the engine memoized thresholds forever — a mid-
        process retune must reroute the SAME engine, not just new ones."""
        eng = MatFnEngine(device="cpu")
        assert eng.route_for(96, 2) == "chain"      # default cpu_max_n=64
        autotune.record_dispatch_thresholds(128, 4096, backend="cpu")
        assert eng.route_for(96, 2) == "torch"        # rerouted, no restart
        autotune.record_dispatch_thresholds(8, 4096, backend="cpu")
        assert eng.route_for(96, 2) == "chain"
        assert eng.route_for(16, 2) == "chain"      # 16 > new cpu_max_n=8

    def test_explicit_thresholds_ignore_retunes(self, tmp_cache):
        eng = MatFnEngine(device="cpu", thresholds=(64, 4096))
        autotune.record_dispatch_thresholds(128, 4096, backend="cpu")
        assert eng.route_for(96, 2) == "chain"      # override pinned

    def test_rerouted_bucket_end_to_end(self, tmp_cache):
        """A recorded threshold change steers the next flush's route."""
        eng = MatFnEngine(device="cpu")
        a = [_mat(40, seed=i) for i in range(2)]
        for m in a:
            eng.submit("matpow", m, power=7)
        eng.flush()
        assert eng.stats["routes"]["torch"] >= 1      # 40 <= 64: torch
        autotune.record_dispatch_thresholds(8, 1 << 30, backend="cpu")
        for m in a:
            eng.submit("matpow", m, power=7)
        eng.flush()
        assert eng.stats["routes"]["chain"] >= 1    # 40 > 8: rerouted

    def test_deadline_entry_round_trip(self, tmp_cache):
        autotune.record_bucket_deadline("matpow", 8, 50.0)
        assert autotune.bucket_deadline_ms("matpow", 8) == 50.0
        # other classes keep the default
        assert autotune.bucket_deadline_ms("matpow", 16) == \
            autotune.DEFAULT_MAX_DELAY_MS
        assert autotune.bucket_deadline_ms("expm", 8) == \
            autotune.DEFAULT_MAX_DELAY_MS
        # dtype-specific beats dtype-agnostic
        autotune.record_bucket_deadline("matpow", 8, 25.0,
                                        dtype=torch.bfloat16)
        assert autotune.bucket_deadline_ms("matpow", 8,
                                           dtype=torch.bfloat16) == 25.0
        assert autotune.bucket_deadline_ms("matpow", 8,
                                           dtype=torch.float32) == 50.0
        autotune.clear_memory_cache()               # survives reload
        assert autotune.bucket_deadline_ms("matpow", 8) == 50.0

    def test_deadline_record_rejections(self, tmp_cache):
        for bad in (0.0, -1.0, float("inf"), float("nan")):
            with pytest.raises(ValueError):
                autotune.record_bucket_deadline("matpow", 8, bad)
        with pytest.raises(ValueError):
            autotune.record_bucket_deadline("", 8, 1.0)
        with pytest.raises(ValueError):
            autotune.record_bucket_deadline("matpow", 0, 1.0)

    def test_deadline_never_answers_other_namespaces(self, tmp_cache):
        autotune.record_bucket_deadline("matpow", 8, 50.0)
        assert autotune.dispatch_thresholds() == \
            autotune.DEFAULT_DISPATCH_THRESHOLDS
        assert autotune.square_tiers() == autotune.DEFAULT_SQUARE_TIERS

    def test_tuned_deadline_drives_daemon_flushes(self, tmp_cache):
        """Per-(op, n, dtype) deadlines resolve from the dispatch namespace
        and steer real flush timing — tuned like every other knob."""
        autotune.record_bucket_deadline("matpow", 8, 50.0, backend="cpu")
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock) as eng:    # no override
            slow = eng.submit("matpow", _mat(8), power=3)     # 50 ms class
            fast = eng.submit("matpow", _mat(16), power=3)    # default 2 ms
            clock.advance(0.010)
            fast.result(timeout=TIMEOUT)
            eng.settle(TIMEOUT)
            assert not slow.done()                 # 10 ms < tuned 50 ms
            clock.advance(0.045)
            slow.result(timeout=TIMEOUT)
            assert eng.stats["flush_triggers"]["deadline"] == 2

    def test_retuned_deadline_applies_to_next_bucket(self, tmp_cache):
        clock = ManualClock()
        with MatFnEngine(device="cpu", max_batch=8, clock=clock) as eng:
            a = eng.submit("matpow", _mat(8), power=3)    # default 2 ms
            autotune.record_bucket_deadline("matpow", 8, 500.0, backend="cpu")
            clock.advance(0.003)
            a.result(timeout=TIMEOUT)           # old bucket: old deadline
            b = eng.submit("matpow", _mat(8), power=3)
            clock.advance(0.010)
            eng.settle(TIMEOUT)
            assert not b.done()                 # new bucket: 500 ms class
            clock.advance(0.5)
            b.result(timeout=TIMEOUT)


class TestAdaptivePolicyIntegration:
    def test_hot_traffic_flushes_before_tuned_deadline(self):
        clock = ManualClock()
        policy = AdaptiveDeadline(min_delay_s=1e-4)
        with MatFnEngine(device="cpu", max_batch=4, clock=clock, max_delay_ms=1000.0,
                         policy=policy) as eng:
            # 100 us inter-arrival gaps across OTHER buckets teach the
            # policy the arrival rate (sizes differ -> no bucket fills).
            futs = []
            for i in range(8):
                futs.append(eng.submit("matpow", _mat(8 + i, seed=i),
                                       power=3))
                clock.advance(1e-4)
            # expected fill ~ gap * max_batch = 400 us << tuned 1000 ms:
            # one more advance past the adaptive deadline flushes them all
            # without ever reaching max_batch or the tuned delay.
            clock.advance(0.01)
            for f in futs:
                f.result(timeout=TIMEOUT)
            assert eng.stats["flush_triggers"]["deadline"] >= 1


class TestAdmissionControl:
    """The daemon's front door: bounded lanes, shed policies, priority."""

    def _eng(self, *, capacity, policy=None, bypass_n=64, clock=None,
             max_batch=200, **kwargs):
        eng = MatFnEngine(device="cpu", 
            max_batch=max_batch, clock=clock or ManualClock(),
            max_delay_ms=10.0,
            admission=AdmissionControl(
                capacity=capacity,
                policy=policy if policy is not None else RejectNewest(),
                bypass_n=bypass_n),
            **kwargs)
        eng.start()
        return eng

    def test_reject_newest_sheds_incoming_synchronously(self):
        eng = self._eng(capacity={"bulk": 3})
        mats = [_mat(8, seed=i) for i in range(5)]
        futs = [eng.submit("matpow", m, power=3) for m in mats[:3]]
        for m in mats[3:]:
            with pytest.raises(ShedError) as ei:
                eng.submit("matpow", m, power=3)
            # Typed, attributable: everything a client needs to react.
            assert ei.value.lane == "bulk"
            assert ei.value.queue_depth == 3
            assert ei.value.capacity == 3
            assert ei.value.policy == "reject-newest"
            assert ei.value.key == ("matpow", 8, "float32", 3)
        snap = eng.stats()
        assert snap["lanes"]["bulk"]["submitted"] == 3
        assert snap["lanes"]["bulk"]["shed"] == 2
        assert snap["lanes"]["bulk"]["queue_depth"] == 3
        # Admitted work is never revoked: all three survive the drain
        # bit-identical.
        eng.close()
        for m, f in zip(mats[:3], futs):
            _check(f.result(), _ref("matpow", m, 3))

    def test_reject_oldest_revokes_admitted_future(self):
        eng = self._eng(capacity={"bulk": 2}, policy=RejectOldest())
        mats = [_mat(8, seed=i) for i in range(3)]
        f0, f1, f2 = [eng.submit("matpow", m, power=3) for m in mats]
        exc = f0.exception(timeout=TIMEOUT)   # oldest paid for the newest
        assert isinstance(exc, ShedError)
        assert exc.lane == "bulk" and exc.policy == "reject-oldest"
        snap = eng.stats()
        assert snap["lanes"]["bulk"]["shed"] == 1
        assert snap["lanes"]["bulk"]["queue_depth"] == 2
        eng.close()
        for m, f in zip(mats[1:], (f1, f2)):
            _check(f.result(), _ref("matpow", m, 3))

    def test_deadline_aware_sheds_least_slack(self, tmp_cache):
        """With per-class tuned deadlines the victim is whoever is closest
        to a dead-on-arrival answer — NOT simply the oldest."""
        autotune.record_bucket_deadline("matpow", 8, 100.0, backend="cpu")
        autotune.record_bucket_deadline("matpow", 16, 1.0, backend="cpu")
        ac = AdmissionControl(capacity={"bulk": 1}, policy=DeadlineAware())
        # Incoming 1 ms class vs pending 100 ms class: the incoming
        # request has the least slack and pays, despite being newest.
        eng = MatFnEngine(device="cpu", clock=ManualClock(), admission=ac)
        eng.start()
        roomy = eng.submit("matpow", _mat(8), power=3)
        with pytest.raises(ShedError):
            eng.submit("matpow", _mat(16), power=3)
        eng.settle(TIMEOUT)
        assert not roomy.done()
        eng.close()
        assert roomy.exception() is None
        # Pending 1 ms class vs incoming 100 ms class: the ADMITTED tight
        # request is revoked and the roomy newcomer takes its slot.
        eng = MatFnEngine(device="cpu", clock=ManualClock(), admission=ac)
        eng.start()
        tight = eng.submit("matpow", _mat(16), power=3)
        admitted = eng.submit("matpow", _mat(8), power=3)
        assert isinstance(tight.exception(timeout=TIMEOUT), ShedError)
        eng.close()
        assert admitted.exception() is None

    @pytest.mark.parametrize("policy_cls", [RejectNewest, RejectOldest])
    def test_exact_shed_accounting_under_producer_threads(self, policy_cls):
        """6 racing producers against one bounded lane: admissions + sheds
        account for every submit exactly, the queue never exceeds its
        capacity, and every SURVIVOR's answer is bit-identical."""
        n_threads, per_thread, cap = 6, 20, 10
        eng = self._eng(capacity={"bulk": cap}, policy=policy_cls())
        mats = [[_mat(8, seed=t * 100 + i) for i in range(per_thread)]
                for t in range(n_threads)]
        admitted = [[] for _ in range(n_threads)]
        raised = [0] * n_threads
        barrier = threading.Barrier(n_threads)

        def producer(t):
            barrier.wait(timeout=TIMEOUT)
            for a in mats[t]:
                try:
                    admitted[t].append((a, eng.submit("matpow", a, power=3)))
                except ShedError:
                    raised[t] += 1

        threads = [threading.Thread(target=producer, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
            assert not th.is_alive()

        total = n_threads * per_thread
        snap = eng.stats()
        # ManualClock: nothing flushed, so the lane sits exactly at its
        # bound — and every request beyond it was shed, no matter how the
        # producers interleaved.
        assert snap["lanes"]["bulk"]["queue_depth"] == cap
        assert snap["lanes"]["bulk"]["peak_depth"] == cap
        assert snap["lanes"]["bulk"]["shed"] == total - cap
        eng.close()
        pairs = [p for fs in admitted for p in fs]
        revoked = [f for _, f in pairs
                   if isinstance(f.exception(), ShedError)]
        served = [(a, f) for a, f in pairs
                  if not isinstance(f.exception(), ShedError)]
        assert sum(raised) + len(revoked) == total - cap
        assert len(served) == cap
        for a, f in served:
            assert f.exception() is None
            _check(f.result(), _ref("matpow", a, 3))

    def test_priority_bypass_flushes_without_time_passing(self):
        clock = ManualClock()
        eng = self._eng(capacity={}, bypass_n=8, clock=clock)
        a = _mat(8)
        fut = eng.submit("matpow", a, power=3, priority="latency")
        # n >= bypass_n: due the moment it arrives — no clock advance.
        _check(fut.result(timeout=TIMEOUT), _ref("matpow", a, 3))
        assert eng.stats["flush_triggers"]["priority"] == 1
        # Below the threshold the latency lane still batches (until its
        # SLO deadline, tested separately).
        small = eng.submit("matpow", _mat(4), power=3, priority="latency")
        eng.settle(TIMEOUT)
        assert not small.done()
        eng.close()

    def test_latency_slo_caps_class_deadline(self):
        """A latency-lane bucket flushes under the lane SLO (0.5 ms) while
        the same traffic class on the bulk lane waits out the tuned 10 ms
        — lanes do not share buckets, only executables."""
        clock = ManualClock()
        eng = self._eng(capacity={}, clock=clock)
        lat = eng.submit("matpow", _mat(8, seed=0), power=3,
                         priority="latency")
        blk = eng.submit("matpow", _mat(8, seed=1), power=3)
        clock.advance(0.001)              # past 0.5 ms SLO, before 10 ms
        lat.result(timeout=TIMEOUT)
        eng.settle(TIMEOUT)
        assert not blk.done()
        clock.advance(0.010)
        blk.result(timeout=TIMEOUT)
        eng.close()

    def test_kick_empty_class_is_noop(self):
        eng = self._eng(capacity={})
        assert eng.kick() == 0
        assert eng.kick(("matpow", 8, "float32", 3)) == 0
        fut = eng.submit("matpow", _mat(8), power=3)
        assert eng.kick(("matpow", 99, "float32", 3)) == 0   # wrong class
        assert eng.stats["flush_triggers"]["kick"] == 0
        assert eng.kick(fut.bucket_key) == 1
        fut.result(timeout=TIMEOUT)
        assert eng.stats["flush_triggers"]["kick"] == 1
        eng.close()

    def test_unknown_lane_rejected(self):
        eng = MatFnEngine(device="cpu")
        with pytest.raises(ValueError, match="unknown priority lane"):
            eng.submit("matpow", _mat(8), power=3, priority="vip")
        eng = self._eng(capacity={})
        with pytest.raises(ValueError, match="unknown priority lane"):
            eng.submit("matpow", _mat(8), power=3, priority="vip")
        eng.close()

    def test_stats_snapshot_schema(self):
        eng = self._eng(capacity={"bulk": 4})
        fut = eng.submit("matpow", _mat(8), power=3)
        snap = eng.stats()
        assert snap["admission_policy"] == "reject-newest"
        assert snap["open_buckets"] == 1 and snap["in_flight"] == 0
        for lane in ("latency", "bulk"):
            row = snap["lanes"][lane]
            for k in ("submitted", "shed", "retried", "flushed",
                      "peak_depth", "queue_depth", "p50_ms", "p95_ms"):
                assert k in row, f"missing {k} in {lane} row"
        assert snap["lanes"]["bulk"]["p95_ms"] is None   # nothing resolved
        # The legacy dict-indexing form keeps working alongside the call.
        assert eng.stats["requests"] == 1
        eng.kick()
        fut.result(timeout=TIMEOUT)
        snap = eng.stats()
        assert snap["lanes"]["bulk"]["flushed"] == 1
        assert snap["lanes"]["bulk"]["queue_depth"] == 0
        assert snap["lanes"]["bulk"]["p95_ms"] is not None
        assert snap["straggler_events"] == []
        # A snapshot is a copy: mutating it must not corrupt the engine.
        snap["lanes"]["bulk"]["flushed"] = 999
        assert eng.stats()["lanes"]["bulk"]["flushed"] == 1
        eng.close()

    def test_close_drain_false_poisons_in_flight_futures(self):
        """A wedged executor must not strand in-flight futures past
        close(drain=False) — they are poisoned immediately, and the
        executor finishing later loses the resolution race quietly."""
        from concurrent.futures import CancelledError
        eng = MatFnEngine(device="cpu", max_batch=2, clock=ManualClock(),
                          max_delay_ms=10.0)
        gate, entered = threading.Event(), threading.Event()
        real = eng._run_chunk

        def wedged_chunk(*args, **kwargs):
            entered.set()
            gate.wait(TIMEOUT)
            return real(*args, **kwargs)

        eng._run_chunk = wedged_chunk
        eng.start()
        in_flight = [eng.submit("matpow", _mat(8, seed=i), power=3)
                     for i in range(2)]    # fills -> scheduler enters gate
        assert entered.wait(TIMEOUT)       # bucket is now IN FLIGHT
        for f in in_flight:
            assert not f.done()
        with pytest.raises(TimeoutError):
            eng.close(drain=False, timeout=0.2)   # executor still wedged
        for f in in_flight:                # ...but nothing hangs:
            assert isinstance(f.exception(timeout=TIMEOUT), CancelledError)
        gate.set()                         # late finish loses the race
        eng.close()
        assert eng._scheduler_crash is None


class TestFaultWiring:
    """Watchdog + bounded retry around bucket execution."""

    def test_transient_failure_retries_to_success(self):
        eng = MatFnEngine(device="cpu", max_batch=2, clock=ManualClock(),
                          max_delay_ms=10.0, retries=1)
        real = eng._run_chunk
        fails = {"left": 1}

        def flaky(*args, **kwargs):
            if fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("transient device loss")
            return real(*args, **kwargs)

        eng._run_chunk = flaky
        eng.start()
        mats = [_mat(8, seed=i) for i in range(2)]
        futs = [eng.submit("matpow", m, power=3) for m in mats]
        for m, f in zip(mats, futs):
            _check(f.result(timeout=TIMEOUT), _ref("matpow", m, 3))
        snap = eng.stats()
        assert snap["retries"] == 1
        assert snap["lanes"]["bulk"]["retried"] == 2
        eng.close()

    def test_retry_evicts_poisoned_cached_executable(self):
        """The self-heal path: a poisoned compile-cache entry costs one
        recompile, not the traffic class forever."""
        eng = MatFnEngine(device="cpu", max_batch=2, clock=ManualClock(),
                          max_delay_ms=10.0, retries=1)
        eng.start()
        warm = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]         # fills -> compiles + caches
        for f in warm:
            assert f.exception(timeout=TIMEOUT) is None
        eng.settle(TIMEOUT)

        def boom(*args, **kwargs):
            raise RuntimeError("poisoned cached executable")

        with eng._cv:
            poisoned = [k for k in eng._executables if k[3] == 8]
            assert poisoned                # the class we just warmed
            for k in poisoned:
                eng._executables[k] = boom
        compiles0 = eng.stats["compiles"]
        mats = [_mat(8, seed=10 + i) for i in range(2)]
        futs = [eng.submit("matpow", m, power=3) for m in mats]
        for m, f in zip(mats, futs):       # healed: correct answers
            _check(f.result(timeout=TIMEOUT), _ref("matpow", m, 3))
        snap = eng.stats()
        assert snap["retries"] == 1
        assert snap["compiles"] > compiles0   # eviction forced a recompile
        eng.close()

    def test_persistent_failure_exhausts_bounded_retries(self):
        eng = MatFnEngine(device="cpu", max_batch=2, clock=ManualClock(),
                          max_delay_ms=10.0, retries=2)
        real = eng._run_chunk
        calls = {"n": 0}

        def broken(*args, **kwargs):
            calls["n"] += 1
            raise RuntimeError("device gone")

        eng._run_chunk = broken
        eng.start()
        futs = [eng.submit("matpow", _mat(8, seed=i), power=3)
                for i in range(2)]
        for f in futs:
            exc = f.exception(timeout=TIMEOUT)
            assert isinstance(exc, BucketExecutionError)
            assert isinstance(exc.__cause__, RuntimeError)
        assert calls["n"] == 3             # initial + 2 bounded retries
        snap = eng.stats()
        assert snap["retries"] == 2
        assert snap["lanes"]["bulk"]["retried"] == 4   # 2 retries x 2 futs
        # The scheduler survived; a healed executor serves fresh traffic.
        eng._run_chunk = real
        ok = eng.submit("matpow", _mat(8, seed=9), power=3)
        eng.kick()
        assert ok.exception(timeout=TIMEOUT) is None
        eng.close()

    def test_straggler_counted_and_logged_without_eviction(self):
        """Stragglers are observability, not a kill switch: the counter
        and log move, the executable cache does NOT (eviction-on-straggle
        recompiles healthy executables and feeds the tail it watches)."""

        class TripEveryTime:
            def observe(self, step, duration_s):
                return StragglerEvent(step, duration_s, 0.0)

        eng = MatFnEngine(device="cpu", max_batch=2, clock=ManualClock(),
                          max_delay_ms=10.0, watchdog=TripEveryTime())
        eng.start()
        first = [eng.submit("matpow", _mat(8, seed=i), power=3)
                 for i in range(2)]
        for f in first:
            assert f.exception(timeout=TIMEOUT) is None
        snap = eng.stats()
        assert snap["stragglers"] >= 1
        assert snap["straggler_events"]
        assert "bucket ('matpow', 8," in snap["straggler_events"][-1]
        hits0 = eng.stats["cache_hits"]
        again = [eng.submit("matpow", _mat(8, seed=10 + i), power=3)
                 for i in range(2)]
        for f in again:
            assert f.exception(timeout=TIMEOUT) is None
        assert eng.stats["cache_hits"] > hits0   # cache survived the trip
        eng.close()

    def test_fault_config_rejections(self):
        with pytest.raises(ValueError):
            MatFnEngine(device="cpu", retries=-1)
        with pytest.raises(ValueError):
            MatFnEngine(device="cpu", retry_backoff_s=-0.1)
