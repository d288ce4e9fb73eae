#!/usr/bin/env python3
"""Where the serving daemon's time goes, on one GPU.

    python3 tools/profile_serve_daemon.py [--requests N] [--rate R]

Serves ``chip_smoke.py``'s serving mix (``serve_requests``: matpow f32 /
bf16 / f64 and expm f32 / f64 over 20 traffic classes) to a
``MatFnEngine`` daemon on the card, open loop from four producer threads,
under variants that each change one thing: the whole mix with tracing, the
same without tracing, a 20 ms flush deadline, the matpow classes alone, the
expm classes alone, the ``"torch"``-route classes (n = 64) alone, and the
whole mix closed loop (everything submitted, then one kick: the largest
buckets the mix allows). Each variant prints one JSON line: requests per
second served, buckets, and host ms per bucket of the execute stage per
route (engine clock). A last run of the whole mix under
``torch.profiler`` prints the device's busy share of the window (kernel and
copy time summed, over wall time: kernels that overlap on two streams count
twice), the CPU time spent in CUDA runtime calls, and
the top CUDA runtime calls and kernels. Then the card's name and power
limit. Needs a CUDA device and ``nvcc``; imports ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG first)
import torch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve import ManualClock, MatFnEngine  # noqa: E402

WARM_BATCHES = (1, 2, 4, 8, 16, 32, 64)


def serve(reqs, *, count, rate, producers=4, closed=False, profiler=None,
          **engine_kw):
    """Serve ``count`` requests drawn from ``reqs``; returns (requests
    served per second, wall seconds, engine stats, per-route execute
    stage: buckets and mean host ms)."""
    rng = np.random.default_rng(501)
    order = rng.integers(0, len(reqs), count)
    if closed:
        engine_kw.update(clock=ManualClock(), max_delay_ms=1e6)
    eng = MatFnEngine(device="cuda", **engine_kw)
    futs = [None] * count
    with eng:
        cs.warm_classes(eng, reqs, lambda *key: WARM_BATCHES)
        torch.cuda.synchronize()
        if profiler is not None:
            profiler.__enter__()
        t0 = time.perf_counter()
        if closed:
            for i in range(count):
                op, a, p, *_ = reqs[order[i]]
                futs[i] = eng.submit(op, a, power=p)
            eng.kick()
        else:
            def producer(k):
                for i in range(k, count, producers):
                    delay = t0 + i / rate - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    op, a, p, *_ = reqs[order[i]]
                    futs[i] = eng.submit(op, a, power=p)

            threads = [threading.Thread(target=producer, args=(k,))
                       for k in range(producers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        for f in futs:
            f.result(timeout=600)
        wall = time.perf_counter() - t0
        if profiler is not None:
            profiler.__exit__(None, None, None)
        snap = eng.stats()
    execute = {}
    for route in ("torch", "chain"):
        h = eng.metrics.merged("stage", stage="execute", route=route)
        execute[route] = {"buckets": h.count,
                          "mean_ms": None if h.mean is None
                          else h.mean * 1e3}
    return count / wall, wall, snap, execute


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=600)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered requests per second (open loop)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(tempfile.mkdtemp(prefix="serve-profile-")) / "autotune.json")
    _build.load()
    pool = cs.serve_requests(cs.SERVE_REQUESTS, 500)
    subsets = {
        "mix": pool,
        "matpow": [r for r in pool if r[0] == "matpow"],
        "expm": [r for r in pool if r[0] == "expm"],
        "torch_route": [r for r in pool if r[1].shape[0] == 64],
    }
    variants = [("mix traced", "mix", dict(trace=True)),
                ("mix", "mix", {}),
                ("mix, 20 ms deadline", "mix", dict(max_delay_ms=20.0)),
                ("matpow classes", "matpow", {}),
                ("expm classes", "expm", {}),
                ("torch-route classes", "torch_route", {}),
                ("mix, closed loop", "mix", dict(closed=True))]
    for label, subset, kw in variants:
        served, wall, snap, execute = serve(subsets[subset],
                                            count=args.requests,
                                            rate=args.rate, **kw)
        print(json.dumps({"variant": label, "offered_req_per_s":
                          None if kw.get("closed") else args.rate,
                          "served_req_per_s": served, "wall_s": wall,
                          "buckets": snap["buckets"],
                          "flush_triggers": snap["flush_triggers"],
                          "execute": execute}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    served, wall, _snap, execute = serve(pool, count=args.requests,
                                         rate=args.rate, profiler=prof)
    events = prof.key_averages()
    runtime = [e for e in events if e.key.startswith("cu")]
    device = [e for e in events if e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in device)
    print(json.dumps({
        "variant": "mix, profiled", "served_req_per_s": served,
        "wall_s": wall, "execute": execute,
        "device_busy_share": device_us / 1e6 / wall,
        "cuda_runtime_cpu_s": sum(e.self_cpu_time_total
                                  for e in runtime) / 1e6,
        "top_runtime_calls": [
            {"name": e.key, "calls": e.count,
             "cpu_ms": e.self_cpu_time_total / 1e3}
            for e in sorted(runtime, key=lambda e: -e.self_cpu_time_total)
            [:8]],
        "top_device": [
            {"name": e.key[:60], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in sorted(device,
                            key=lambda e: -e.self_device_time_total)[:8]],
    }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
