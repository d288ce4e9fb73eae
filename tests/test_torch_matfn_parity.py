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
the two frameworks sum in different orders, so bits are not claimed.
"""

import numpy as np
import pytest

from repro.serve.matfn import MatFnEngine as RefEngine
from repro.serve.scheduler import ManualClock as RefClock
from repro_torch.serve.matfn import MatFnEngine
from repro_torch.serve.scheduler import ManualClock

from _torch_parity import assert_close, matpow_mults, pair

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


@pytest.mark.parametrize("module", [
    "serve", "serve.matfn", "serve.admission", "serve.scheduler",
    "serve.streams", "runtime", "runtime.telemetry", "runtime.fault",
    "launch.matserve"])
def test_the_port_has_the_reference_public_names(module):
    """Every public name of the reference's serving modules is in the
    port's module of the same name (``__all__``, or the public functions
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
