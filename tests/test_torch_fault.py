"""The port's fault-tolerance runtime (repro_torch.runtime.fault, a copy of
the reference's): watchdog, retry, elastic mesh planning. The reference's
tests/test_fault.py with the imports swapped."""

import threading

import pytest

from repro_torch.runtime.fault import (Watchdog, retry_step,
                                       plan_elastic_mesh, StragglerEvent)


class TestWatchdog:
    def test_no_event_during_warmup(self):
        dog = Watchdog(min_samples=5)
        for i in range(4):
            assert dog.observe(i, 1.0) is None

    def test_straggler_detected(self):
        dog = Watchdog(timeout_factor=3.0, min_samples=5)
        for i in range(8):
            dog.observe(i, 1.0)
        ev = dog.observe(8, 10.0)
        assert isinstance(ev, StragglerEvent)
        assert ev.duration_s == 10.0
        assert "straggler" in str(ev)

    def test_median_robust_to_single_spike(self):
        dog = Watchdog(timeout_factor=3.0, min_samples=5)
        for i in range(8):
            dog.observe(i, 1.0)
        dog.observe(8, 10.0)             # spike
        assert dog.observe(9, 1.1) is None   # back to normal -> no event

    def test_concurrent_observers_stress(self):
        """The matfn daemon's per-route execution streams observe into
        ONE shared watchdog concurrently. Repeat-until-stable (bounded
        rounds): every round hammers observe() from several threads,
        then asserts the invariants the lock protects — the rolling
        window never overshoots its bound, straggler counting is exact,
        and no observer ever crashes on a mid-mutation window."""
        n_threads, per_thread, rounds = 4, 200, 3
        for r in range(rounds):
            dog = Watchdog(timeout_factor=3.0, window=32, min_samples=5)
            errors, events = [], []
            ev_lock = threading.Lock()
            start = threading.Barrier(n_threads)

            def observer(tid):
                try:
                    start.wait()
                    for i in range(per_thread):
                        # every 50th observation is a 100x straggler
                        dur = 100.0 if i % 50 == 25 else 1.0
                        ev = dog.observe(tid * per_thread + i, dur)
                        if ev is not None:
                            with ev_lock:
                                events.append(ev)
                except BaseException as exc:  # surfaced, not swallowed
                    errors.append(exc)

            threads = [threading.Thread(target=observer, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
            assert not any(t.is_alive() for t in threads)
            assert not errors, f"observer crashed: {errors[0]!r}"
            # window bound held under concurrency (the append/pop race
            # the lock exists to prevent would overshoot it)
            assert len(dog._durations) <= dog.window
            # exact accounting: every returned event landed in the ring,
            # and every 100x spike past warmup tripped (median stays 1.0
            # — spikes are 2% of samples, far under the window majority)
            spikes = n_threads * (per_thread // 50)
            assert len(events) == len(dog.events)
            assert spikes - 1 <= len(events) <= spikes
            for ev in events:
                assert ev.duration_s == 100.0 and ev.median_s == 1.0


class TestRetry:
    def test_succeeds_after_transient_failures(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        assert retry_step(flaky, retries=3, backoff_s=0.0) == "ok"
        assert calls["n"] == 3

    def test_exhausts_and_reraises(self):
        def broken():
            raise RuntimeError("persistent")

        with pytest.raises(RuntimeError, match="persistent"):
            retry_step(broken, retries=2, backoff_s=0.0)

    def test_on_retry_callback(self):
        seen = []

        def flaky():
            if len(seen) < 1:
                raise ValueError("x")
            return 1

        retry_step(flaky, retries=2, backoff_s=0.0,
                   on_retry=lambda a, e: seen.append((a, str(e))))
        assert seen == [(1, "x")]


class TestElasticMesh:
    def test_full_pod(self):
        shape, axes = plan_elastic_mesh(256, tp=16)
        assert shape == (16, 16) and axes == ("data", "model")

    def test_lost_one_host_row(self):
        # 248 healthy chips -> drop to 15 data rows, TP intact
        shape, _ = plan_elastic_mesh(248, tp=16)
        assert shape == (15, 16)
        assert shape[0] * shape[1] <= 248

    def test_degrade_tp_when_tiny(self):
        shape, _ = plan_elastic_mesh(8, tp=16)
        assert shape[1] <= 8 and shape[0] * shape[1] <= 8

    def test_single_chip(self):
        shape, _ = plan_elastic_mesh(1, tp=16)
        assert shape == (1, 1)
