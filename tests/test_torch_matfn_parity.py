"""The port's serving engine against the reference's, on one scripted
traffic list.

The same requests — (op, n, dtype, power, seed, lane), operands made from a
numpy seed and rounded once (``_torch_parity.pair``) — go through the
reference's ``repro.serve.matfn.MatFnEngine(interpret=True)`` (Pallas
kernel bodies in interpret mode) and the port's
``repro_torch.serve.matfn.MatFnEngine(device="cpu")`` (the kernels' plain
versions), each on a ``ManualClock``. Held equal: the bucket keys and
padded batches, the routes (the reference's ``xla`` is the port's
``torch``), the flush triggers step by step, and the counters
(``submitted`` / ``flushed`` per lane, ``compiles``, ``cache_hits``,
``buckets``, ``padded_slots``). Each answer is held to the reference's
under ``error_budget(dtype, n, mults)`` (``_torch_parity.assert_close``):
the two frameworks sum in different orders, so bits are not claimed. A
second script sends Markov steady-state and evolve traffic and Strassen
(``fastmm``) buckets through both engines the same way: steady states are
held by their squaring counts, ``pi`` and matrix, Strassen answers under
``error_budget(levels=2)``.
"""

import numpy as np
import pytest
import torch

from repro.serve.matfn import MatFnEngine as RefEngine
from repro.serve.scheduler import ManualClock as RefClock
from repro_torch.serve.matfn import MatFnEngine
from repro_torch.serve.scheduler import ManualClock

from _torch_parity import as_f64, assert_close, matpow_mults, pair
from repro_torch.kernels import error_budget

pytestmark = pytest.mark.timeout(300)

TIMEOUT = 60.0   # real-time backstop on future waits; never load-bearing
MAX_BATCH = 4

#: (op, n, dtype, power, seed, lane), in submission order, split into the
#: steps between which the script moves the clock. n <= 64 takes the
#: torch / xla route, n = 96 the kernel chain; four (matpow, 8, f32, 3)
#: bulk requests fill a bucket; the latency request at n = 96 is at the
#: default bypass size and dispatches directly.
STEPS = (
    [("matpow", 8, "float32", 3, 1, "bulk"),
     ("matpow", 8, "float32", 3, 2, "bulk"),
     ("matpow", 16, "bfloat16", 7, 3, "bulk"),
     ("expm", 16, "float32", 1, 4, "bulk"),
     ("matpow", 8, "float32", 3, 5, "bulk"),
     ("matpow", 8, "float32", 3, 6, "bulk")],
    [("matpow", 96, "float32", 7, 7, "bulk"),
     ("matpow", 16, "float32", 7, 8, "latency"),
     ("matpow", 96, "float32", 5, 9, "latency"),
     ("matpow", 16, "bfloat16", 7, 10, "bulk"),
     ("expm", 16, "float32", 1, 11, "bulk")],
    [("matpow", 8, "float32", 3, 12, "bulk"),
     ("matpow", 96, "bfloat16", 3, 13, "bulk"),
     ("expm", 96, "float32", 1, 14, "bulk")],
)


def _operand(n, seed, dtype):
    rng = np.random.default_rng(seed)
    return pair(rng.standard_normal((n, n)) * 0.4 / np.sqrt(n), dtype)


def _mults(op, power):
    return 8 if op == "expm" else matpow_mults(power)


def _canon_route(route):
    return "torch" if route == "xla" else route


def _triggers(tracer):
    """Sorted (trigger, op, n, dtype, power, lane) of every dispatched
    bucket, from the scheduler's ``bucket.batch`` spans."""
    return sorted((s["args"]["trigger"], s["args"]["op"], s["args"]["n"],
                   s["args"]["dtype"], str(s["args"]["power"]),
                   s["args"]["lane"])
                  for s in tracer.spans() if s["name"] == "bucket.batch")


def _counters(snap):
    return {
        "requests": snap["requests"], "buckets": snap["buckets"],
        "compiles": snap["compiles"], "cache_hits": snap["cache_hits"],
        "padded_slots": snap["padded_slots"],
        "routes": {_canon_route(r): c for r, c in snap["routes"].items()},
        "flush_triggers": snap["flush_triggers"],
        "lanes": {lane: {k: row[k] for k in ("submitted", "flushed", "shed",
                                             "peak_depth", "queue_depth")}
                  for lane, row in snap["lanes"].items()},
    }


def _bucket_rows(rows):
    return sorted((op, _canon_route(route), bpad, n, dtype, power,
                   row["requests"])
                  for row in rows
                  for (op, route, bpad, n, dtype, power) in [row["key"]])


class TestDaemonParity:
    def _serve(self, engine, clock, operands):
        """Run the script; returns (answers, the dispatched buckets after
        each step, stats)."""
        futs, steps = [], []
        with engine:
            for step in STEPS:
                for (op, n, dtype, power, seed, lane) in step:
                    futs.append(engine.submit(op, operands[seed], power=power,
                                              priority=lane))
                engine.settle(TIMEOUT)
                clock.advance(0.020)      # every deadline of the step fires
                engine.settle(TIMEOUT)
                steps.append(_triggers(engine.tracer))
            answers = [f.result(timeout=TIMEOUT) for f in futs]
            snap = engine.stats()
        return answers, steps, snap

    def test_same_buckets_routes_triggers_counters_and_answers(self):
        script = [req for step in STEPS for req in step]
        ref_ops, port_ops = {}, {}
        for (op, n, dtype, power, seed, lane) in script:
            ref_ops[seed], port_ops[seed] = _operand(n, seed, dtype)

        ref_clock, port_clock = RefClock(), ManualClock()
        ref = RefEngine(interpret=True, max_batch=MAX_BATCH, clock=ref_clock,
                        trace=True)
        port = MatFnEngine(device="cpu", max_batch=MAX_BATCH,
                           clock=port_clock, trace=True)
        want, ref_steps, ref_snap = self._serve(ref, ref_clock, ref_ops)
        got, port_steps, port_snap = self._serve(port, port_clock, port_ops)

        assert port_steps == ref_steps
        assert _counters(port_snap) == _counters(ref_snap)
        triggers = port_snap["flush_triggers"]
        assert triggers["fill"] >= 1 and triggers["deadline"] >= 1
        assert triggers["priority"] == 1
        assert port_snap["routes"]["chain"] >= 1
        assert port_snap["routes"]["torch"] >= 1
        for (op, n, dtype, power, seed, lane), g, w in zip(script, got,
                                                           want):
            assert_close(g, w, dtype, n=n, mults=_mults(op, power),
                         err_msg=f"{op} n={n} {dtype} p={power} {lane}")


class TestSyncParity:
    def test_same_bucket_rows_and_answers(self):
        script = [req for step in STEPS for req in step]
        ref = RefEngine(interpret=True, max_batch=MAX_BATCH)
        port = MatFnEngine(device="cpu", max_batch=MAX_BATCH)
        for (op, n, dtype, power, seed, _lane) in script:
            ja, ta = _operand(n, seed, dtype)
            assert ref.submit(op, ja, power=power) == \
                port.submit(op, ta, power=power)
        want, got = ref.flush(), port.flush()
        assert _bucket_rows(port.stats["last_flush"]) == \
            _bucket_rows(ref.stats["last_flush"])
        for key in ("requests", "buckets", "compiles", "cache_hits",
                    "padded_slots"):
            assert port.stats[key] == ref.stats[key], key
        for (op, n, dtype, power, _seed, _lane), g, w in zip(script, got,
                                                             want):
            assert_close(g, w, dtype, n=n, mults=_mults(op, power),
                         err_msg=f"{op} n={n} {dtype} p={power}")


#: The Markov and Strassen traffic of both engines, on thresholds (8, ...)
#: and a fastmm crossover of 16 (two levels) recorded in both caches: n = 8
#: takes torch / xla, n = 16 the chain, n = 40 fastmm, and evolve requests
#: the evolve route. (op, n, power, seed, lane, B): B is the
#: distribution count of an evolve request, None otherwise.
MARKOV_STEPS = (
    [("markov", 8, 1, 21, "bulk", None),
     ("markov", 8, 1, 22, "bulk", None),
     ("markov", 16, 1, 23, "bulk", None),
     ("markov", 16, 13, 24, "bulk", 3),
     ("matpow", 40, 3, 25, "bulk", None)],
    [("expm", 40, 1, 26, "bulk", None),
     ("markov", 40, 1, 27, "bulk", None),
     ("markov", 16, 13, 28, "bulk", 3),
     ("matpow", 8, 3, 29, "bulk", None)],
)
MARKOV_THRESHOLDS = (8, 1 << 30)


def _markov_inputs(op, n, power, seed, b):
    """(jax, torch) operand and dists (or None) of one scripted request:
    stochastic matrices for markov, scaled normals otherwise."""
    rng = np.random.default_rng(seed)
    if op == "markov":
        m = rng.random((n, n)) + 0.05
        a = pair(m / m.sum(axis=1, keepdims=True), "float32")
    else:
        a = pair(rng.standard_normal((n, n)) * 0.4 / np.sqrt(n), "float32")
    if b is None:
        return a, (None, None)
    d = rng.random((b, n))
    return a, pair(d / d.sum(axis=1, keepdims=True), "float32")


def _check_markov_answer(req, got, want):
    """One answer of the Markov / Strassen script against the reference's:
    steady states by squarings, pi and matrix; the rest elementwise;
    fastmm-route answers (n = 40) under the two-level budget."""
    op, n, power, _seed, _lane, b = req
    levels = 2 if n > 16 and b is None else 0
    what = f"{op} n={n} p={power} B={b}"
    if op == "markov" and b is None:
        assert int(got.squarings) == int(want.squarings), what
        for g, w in ((got.pi, want.pi), (got.matrix, want.matrix)):
            rtol, atol = error_budget(torch.float32, levels=levels, n=n,
                                      mults=int(got.squarings))
            np.testing.assert_allclose(as_f64(g), as_f64(w), rtol=rtol,
                                       atol=atol, err_msg=what)
        return
    mults = (power.bit_length() - 1 + bin(power).count("1")
             if op == "markov" else _mults(op, power))
    rtol, atol = error_budget(torch.float32, levels=levels, n=n, mults=mults)
    np.testing.assert_allclose(as_f64(got), as_f64(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture
def both_caches(tmp_path, monkeypatch):
    """A temporary tuning cache for each package, each holding a fastmm
    crossover of 16 at two levels."""
    from repro.kernels import autotune as jautotune
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "port.json"))
    jautotune.clear_memory_cache()
    autotune.clear_memory_cache()
    jautotune.record_fastmm(16, 2)
    autotune.record_fastmm(16, 2, backend="cpu")
    yield
    jautotune.clear_memory_cache()
    autotune.clear_memory_cache()


class TestMarkovAndFastmmParity:
    """Markov steady-state, evolve and Strassen (``fastmm``) traffic through
    both engines: the same buckets, routes, triggers and counters, and
    every answer within the stated budget of the reference's."""

    @staticmethod
    def _inputs():
        ref_in, port_in = {}, {}
        for step in MARKOV_STEPS:
            for (op, n, power, seed, lane, b) in step:
                (ja, ta), (jd, td) = _markov_inputs(op, n, power, seed, b)
                ref_in[seed], port_in[seed] = (ja, jd), (ta, td)
        return ref_in, port_in

    @staticmethod
    def _serve(engine, clock, inputs):
        futs, steps = [], []
        with engine:
            for step in MARKOV_STEPS:
                for (op, n, power, seed, lane, b) in step:
                    a, d = inputs[seed]
                    futs.append(engine.submit(op, a, power=power, dists=d,
                                              priority=lane))
                engine.settle(TIMEOUT)
                clock.advance(0.020)      # every deadline of the step fires
                engine.settle(TIMEOUT)
                steps.append(_triggers(engine.tracer))
            answers = [f.result(timeout=TIMEOUT) for f in futs]
            snap = engine.stats()
        return answers, steps, snap

    def test_daemon_buckets_routes_triggers_counters_and_answers(
            self, both_caches):
        ref_in, port_in = self._inputs()
        ref_clock, port_clock = RefClock(), ManualClock()
        ref = RefEngine(interpret=True, max_batch=MAX_BATCH, clock=ref_clock,
                        thresholds=MARKOV_THRESHOLDS, trace=True)
        port = MatFnEngine(device="cpu", max_batch=MAX_BATCH,
                           clock=port_clock, thresholds=MARKOV_THRESHOLDS,
                           trace=True)
        want, ref_steps, ref_snap = self._serve(ref, ref_clock, ref_in)
        got, port_steps, port_snap = self._serve(port, port_clock, port_in)

        assert port_steps == ref_steps
        assert _counters(port_snap) == _counters(ref_snap)
        routes = port_snap["routes"]
        assert routes["fastmm"] == 3 and routes["evolve"] == 2
        assert routes["chain"] == 1 and routes["torch"] == 2
        assert port_snap["flush_triggers"]["deadline"] >= 1
        script = [req for step in MARKOV_STEPS for req in step]
        for req, g, w in zip(script, got, want):
            _check_markov_answer(req, g, w)

    def test_sync_bucket_rows_and_answers(self, both_caches):
        ref_in, port_in = self._inputs()
        ref = RefEngine(interpret=True, max_batch=MAX_BATCH,
                        thresholds=MARKOV_THRESHOLDS)
        port = MatFnEngine(device="cpu", max_batch=MAX_BATCH,
                           thresholds=MARKOV_THRESHOLDS)
        script = [req for step in MARKOV_STEPS for req in step]
        for (op, n, power, seed, _lane, _b) in script:
            (ja, jd), (ta, td) = ref_in[seed], port_in[seed]
            assert ref.submit(op, ja, power=power, dists=jd) == \
                port.submit(op, ta, power=power, dists=td)
        want, got = ref.flush(), port.flush()
        assert _bucket_rows(port.stats["last_flush"]) == \
            _bucket_rows(ref.stats["last_flush"])
        for key in ("requests", "buckets", "compiles", "cache_hits",
                    "padded_slots"):
            assert port.stats[key] == ref.stats[key], key
        for req, g, w in zip(script, got, want):
            _check_markov_answer(req, g, w)


@pytest.mark.parametrize("module", [
    "serve", "serve.matfn", "serve.admission", "serve.scheduler",
    "serve.streams", "runtime", "runtime.telemetry", "runtime.fault",
    "launch.matserve", "core.markov", "kernels.fastmm"])
def test_the_port_has_the_reference_public_names(module):
    """Every public name of the reference's serving modules (and of the
    Markov and Strassen modules) is in the port's module of the same name (``__all__``, or the public functions
    where the reference has none)."""
    import importlib
    import inspect
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")

    def public(mod):
        if hasattr(mod, "__all__"):
            return set(mod.__all__)
        return {name for name, obj in vars(mod).items()
                if not name.startswith("_") and inspect.isfunction(obj)
                and obj.__module__ == mod.__name__}

    missing = public(ref) - set(dir(port))
    assert not missing, missing
