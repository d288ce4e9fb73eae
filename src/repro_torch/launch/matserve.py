"""Matrix-function serving driver: mixed (n, power) traffic through the
bucketing engine (the port of the reference's ``repro.launch.matserve``).

Batch (library) mode — submit everything, flush once::

    PYTHONPATH=src python -m repro_torch.launch.matserve \
        --requests 64 --sizes 8,16,32 --powers 2,7,12 --expm-frac 0.25

Daemon (continuous-batching) mode — an OPEN-LOOP synthetic traffic
generator submits at a fixed offered rate (arrivals independent of
completions), the background scheduler flushes buckets on
fill-or-deadline, and the report shows per-request latency percentiles
next to throughput::

    PYTHONPATH=src python -m repro_torch.launch.matserve \
        --daemon --rate 500 --requests 256 --sizes 16,32 --powers 7,12

The engine runs on the GPU (``--device cuda``, the default; it raises
without one) or, with ``--device cpu`` (or the reference's
``--interpret``), on the plain PyTorch versions of the kernels.
``--verify`` replays every request as a per-matrix call of the port's
``matpow_binary`` / ``expm`` in float64 and holds each answer to it under
``error_budget``; a miss makes matserve exit with 1.

Differences from the reference, on purpose: the Markov route is not ported,
so ``--markov-frac`` and ``--evolve-frac`` above 0 and any
``--evolve-batch`` are refused, and ``--evolve-frac`` defaults to 0 (the
reference's default is 0.5).
"""

from __future__ import annotations

import argparse
import queue
import threading
import time

import numpy as np
import torch

from repro_torch import DTYPES, default_device
from repro_torch.kernels.fastmm import error_budget
from repro_torch.serve.admission import POLICIES, AdmissionControl, ShedError
from repro_torch.serve.matfn import ROUTES, MatFnEngine


def make_workload(n_requests: int, sizes, powers, expm_frac: float,
                  seed: int, dtypes=("float32",), device="cpu"):
    """A reproducible mixed request list of ``(op, operand, power)`` tuples,
    the operands made on ``device`` from a numpy seed (the reference's
    markov arguments wait for the Markov route)."""
    rng = np.random.default_rng(seed)
    work = []
    for _ in range(n_requests):
        n = int(rng.choice(sizes))
        dtype = DTYPES[str(rng.choice(dtypes))]
        raw = rng.standard_normal((n, n))
        a = torch.tensor(raw * 0.4 / np.sqrt(n), dtype=dtype, device=device)
        if rng.random() < expm_frac:
            work.append(("expm", a, 1))
        else:
            work.append(("matpow", a, int(rng.choice(powers))))
    return work


def run_workload(engine: MatFnEngine, workload):
    """Submit everything, flush once; returns (results, seconds)."""
    t0 = time.perf_counter()
    for op, a, power, *_ in workload:
        engine.submit(op, a, power=power)
    results = engine.flush()
    return results, time.perf_counter() - t0


def run_open_loop(engine: MatFnEngine, workload, rate: float, *,
                  timeout: float = 120.0, lanes=None, arrivals=None,
                  tenants=None):
    """Open-loop traffic against a STARTED daemon engine.

    Requests are submitted at their scheduled arrival times ``i / rate``
    regardless of completions (``arrivals`` overrides the schedule with
    explicit offsets in seconds); ``lanes`` names the admission lane per
    request (default all ``"bulk"``), ``tenants`` the tenant tag.

    Shedding is part of the measured behavior, not an error: a shed
    request's ``results`` slot holds its :class:`ShedError` and its latency
    is ``None``. Any OTHER failure raises. A collector thread waits on each
    future in submission order; with ``profile=True`` latency is the
    future's own ``resolved_at - submitted_at`` (both on the engine clock),
    otherwise the collector's ``now - submit_time``.

    Returns ``(results, latencies_s, wall_s, info)``; ``info`` carries
    ``shed`` and ``submit_wall_s`` (the submission window alone).
    """
    if not engine.running:
        raise RuntimeError("run_open_loop needs a started daemon engine")
    profiled = engine.profile
    n = len(workload)
    if lanes is None:
        lanes = ["bulk"] * n
    results, lats = [None] * n, [None] * n
    inbox: "queue.Queue" = queue.Queue()
    collector_error = []

    def collect():
        try:
            while True:
                item = inbox.get()
                if item is None:           # sentinel: generator is done
                    return
                i, fut, t0 = item
                try:
                    r = fut.result(timeout=timeout)
                except ShedError as exc:   # reject-oldest revoked this one
                    results[i] = exc
                    continue
                results[i] = r
                if profiled and fut.resolved_at is not None \
                        and fut.submitted_at is not None:
                    lats[i] = fut.resolved_at - fut.submitted_at
                else:
                    lats[i] = time.perf_counter() - t0
        except BaseException as exc:       # surface on the caller thread
            collector_error.append(exc)

    collector = threading.Thread(target=collect, name="matserve-collect")
    collector.start()
    t_start = time.perf_counter()
    submit_wall = 0.0
    try:
        for i, (op, a, power, *_) in enumerate(workload):
            target = t_start + (arrivals[i] if arrivals is not None
                                else i / rate)
            while True:
                remaining = target - time.perf_counter()
                if remaining <= 0:
                    break
                time.sleep(min(remaining, 5e-4))
            try:
                fut = engine.submit(op, a, power=power, priority=lanes[i],
                                    tenant=None if tenants is None
                                    else tenants[i])
            except ShedError as exc:       # reject-newest: shed at the door
                results[i] = exc
                continue
            finally:
                submit_wall = time.perf_counter() - t_start
            inbox.put((i, fut, time.perf_counter()))
    finally:
        # Always unblock the collector — a submit raising mid-loop must
        # not leave a thread parked on inbox.get() forever.
        inbox.put(None)
        collector.join()
    if collector_error:
        raise collector_error[0]
    shed = sum(1 for r in results if isinstance(r, ShedError))
    info = {"shed": shed, "submit_wall_s": submit_wall}
    return results, lats, time.perf_counter() - t_start, info


def _mults(op: str, power: int) -> int:
    """Multiplies behind one answer, for ``error_budget``: the binary
    chain's for matpow, the Pade-13 polynomial's six and the solve's for
    expm (the workload's operands need no squaring)."""
    if op == "expm":
        return 8
    if power <= 1:
        return 1
    return (power.bit_length() - 1) + (bin(power).count("1") - 1)


def verify(workload, results) -> tuple:
    """Hold every served answer to the port's per-matrix ``matpow_binary``
    / ``expm`` in float64 (``backend="torch"``) under ``error_budget(dtype,
    n, mults)``, elementwise and against the peak-relative floor. Returns
    (worst max |answer - float64|, number of misses)."""
    from repro_torch.core import expm, matpow_binary

    worst, misses = 0.0, 0
    for (op, a, power, *_), got in zip(workload, results):
        if isinstance(got, ShedError):     # shed requests have no answer
            continue
        a64 = a.double()
        want = expm(a64) if op == "expm" else matpow_binary(a64, power)
        n = a.shape[0]
        rtol, atol = error_budget(a.dtype, n=n, mults=_mults(op, power))
        got64 = got.double()
        diff = (got64 - want).abs()
        err = float(diff.max())
        peak = float(want.abs().max())
        ok = (bool(torch.isfinite(got64).all())
              and bool((diff <= atol + rtol * want.abs()).all())
              and err <= error_budget(a.dtype)[0] * max(peak, 1e-300))
        worst = max(worst, err)
        misses += not ok
    return worst, misses


def _report_verify(workload, results) -> int:
    worst, misses = verify(workload, results)
    print(f"[matserve] verify: max |served - float64 per-matrix| = "
          f"{worst:.2e}; {misses} outside error_budget")
    return 1 if misses else 0


def percentile(xs, q):
    """Shared p50/p95 helper."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _parse_capacity(spec):
    """``"bulk=96,latency=32"`` -> AdmissionControl capacity mapping
    (unnamed lanes stay unbounded). ``None``/empty -> all unbounded."""
    caps = {}
    if spec:
        for part in spec.split(","):
            lane, _, val = part.partition("=")
            caps[lane.strip()] = int(val)
    return caps


def _daemon_main(args, workload, device):
    from repro_torch.serve.scheduler import AdaptiveDeadline, FillOrDeadline

    policy = AdaptiveDeadline() if args.policy == "adaptive" \
        else FillOrDeadline()
    caps = _parse_capacity(args.capacity)
    admission = AdmissionControl(
        capacity={"bulk": caps.get("bulk"), "latency": caps.get("latency")},
        policy=POLICIES[args.admission]())
    # profile=True: each bucket is timed to device completion, and the
    # latency report reads the futures' own engine-clock stamps.
    engine = MatFnEngine(device=device, max_batch=args.max_batch,
                         profile=True, policy=policy,
                         max_delay_ms=args.max_delay_ms,
                         admission=admission,
                         trace=bool(args.trace))
    engine.start()
    # Prewarm every bucket shape the workload can produce so the timed run
    # never pays a first call on the latency path.
    for op, n, dtype, power in {(op, a.shape[0], a.dtype, p)
                                for op, a, p, *_ in workload}:
        engine.warm(op, n, dtype=dtype, power=power)
    rng = np.random.default_rng(args.seed + 1)
    lanes = ["latency" if rng.random() < args.priority_frac else "bulk"
             for _ in workload]
    try:
        results, lats, wall, info = run_open_loop(engine, workload,
                                                  args.rate, lanes=lanes)
    finally:
        snap = engine.stats()
        if args.trace:
            engine.tracer.export(args.trace)
            print(f"[matserve] trace: {len(engine.tracer)} spans "
                  f"({engine.tracer.dropped} dropped) -> {args.trace}")
        engine.close()

    served = [t for t in lats if t is not None]
    print(f"[matserve] daemon: {len(workload)} requests, offered "
          f"{args.rate:.0f} req/s, served {len(served)} in "
          f"{wall*1e3:.1f} ms ({len(served) / wall:.0f} req/s) — "
          f"device={device} policy={args.policy} "
          f"max_delay_ms={args.max_delay_ms} "
          f"admission={snap['admission_policy']} shed={info['shed']}")
    if served:
        print(f"[matserve]   latency p50={percentile(served, 50)*1e3:.2f} ms "
              f"p95={percentile(served, 95)*1e3:.2f} ms "
              f"max={max(served)*1e3:.2f} ms")
    print(f"[matserve]   buckets={snap['buckets']} "
          f"compiles={snap['compiles']} "
          f"flush_triggers={snap['flush_triggers']} "
          f"routes={snap['routes']} stragglers={snap['stragglers']} "
          f"retries={snap['retries']}")
    for lane, row in snap["lanes"].items():
        p95 = "n/a" if row["p95_ms"] is None else f"{row['p95_ms']:.2f} ms"
        print(f"[matserve]   lane {lane:8s} submitted={row['submitted']} "
              f"shed={row['shed']} flushed={row['flushed']} "
              f"retried={row['retried']} peak_depth={row['peak_depth']} "
              f"p95={p95}")
    for row in snap["streams"]:
        crashed = "" if row["crashed"] is None \
            else f" CRASHED: {row['crashed']}"
        print(f"[matserve]   {row['label']:24s} executed={row['executed']} "
              f"queued={row['queued']} in_flight={row['in_flight']}"
              f"{crashed}")
    print(f"[matserve]   peak concurrent streams="
          f"{snap['peak_concurrent_streams']}")
    for stage, h in snap["stages"].items():
        print(f"[matserve]   stage {stage:9s} n={h['count']:<6d} "
              f"p50={h['p50']*1e3:7.3f} ms p95={h['p95']*1e3:7.3f} ms "
              f"total={h['sum']*1e3:8.1f} ms")
    for ev in snap["watchdog_events"]:
        print(f"[matserve]   watchdog: step={ev['step']} "
              f"duration={ev['duration_s']*1e3:.2f} ms "
              f"median={ev['median_s']*1e3:.2f} ms")
    if args.verify:
        return _report_verify(workload, results)
    return 0


def _batch_main(args, workload, device):
    # profile=True: per-bucket wall times for the report below.
    engine = MatFnEngine(device=device, max_batch=args.max_batch,
                         profile=True, trace=bool(args.trace))
    # The warm flush prepares the bucket callables (and builds the kernels
    # on the card); the timed flush reuses them.
    run_workload(engine, workload)
    results, dt = run_workload(engine, workload)

    s = engine.stats
    # Per-FLUSH numbers from the timed flush's bucket rows; compiles stay
    # cumulative (they all happened in the warm flush).
    rows = s["last_flush"]
    routes = {r: sum(1 for x in rows if x["route"] == r) for r in ROUTES}
    padded = sum(x["padded_batch"] - x["requests"] for x in rows)
    print(f"[matserve] {args.requests} requests in {dt*1e3:.1f} ms "
          f"({args.requests/dt:.0f} req/s) — device={device} "
          f"thresholds={engine.thresholds}")
    print(f"[matserve]   buckets={len(rows)} "
          f"compiles={s['compiles']} (warm flush) "
          f"padded_slots={padded} routes={routes}")
    for row in rows:
        op, route, bpad, n, dtype, power = row["key"]
        print(f"[matserve]   bucket {op:6s} n={n:<5d} p={power!s:<4} {dtype} "
              f"-> {route:6s} B={row['requests']}/{row['padded_batch']} "
              f"{row['seconds']*1e3:7.2f} ms")
    if args.trace:
        engine.tracer.export(args.trace)
        print(f"[matserve] trace: {len(engine.tracer)} spans -> "
              f"{args.trace}")
    if args.verify:
        return _report_verify(workload, results)
    return 0


def parser() -> argparse.ArgumentParser:
    """matserve's command line (the reference's flags and ``--device``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sizes", default="8,16,32",
                    help="comma-separated matrix sizes")
    ap.add_argument("--powers", default="2,7,12",
                    help="comma-separated matpow powers")
    ap.add_argument("--expm-frac", type=float, default=0.25,
                    help="fraction of requests that are expm")
    ap.add_argument("--markov-frac", type=float, default=0.0,
                    help="fraction of markov traffic (refused above 0: not "
                         "ported yet)")
    ap.add_argument("--evolve-frac", type=float, default=0.0,
                    help="fraction of markov requests that evolve a "
                         "distribution stack (refused above 0: not ported "
                         "yet)")
    ap.add_argument("--evolve-batch", type=int, default=None,
                    help="distributions per evolve request (refused: not "
                         "ported yet)")
    ap.add_argument("--dtypes", default="float32",
                    help="comma-separated operand dtypes (e.g. "
                         "float32,bfloat16,float64)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine computes: cuda (default; raises "
                         "without a GPU) or cpu (the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--interpret", action="store_true",
                    help="the reference's flag: the same as --device cpu")
    ap.add_argument("--verify", action="store_true",
                    help="hold every answer to a float64 per-matrix call "
                         "under error_budget (exit 1 on a miss)")
    ap.add_argument("--daemon", action="store_true",
                    help="continuous-batching daemon + open-loop traffic")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="daemon mode: offered load, requests/second")
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="daemon mode: bucket flush deadline override "
                         "(default: per traffic class from the dispatch "
                         "namespace)")
    ap.add_argument("--policy", choices=("fill", "adaptive"), default="fill",
                    help="daemon flush policy")
    ap.add_argument("--admission", choices=sorted(POLICIES),
                    default="reject-newest",
                    help="daemon mode: shed policy on lane overflow")
    ap.add_argument("--capacity", default="",
                    help="daemon mode: per-lane queue bounds, e.g. "
                         "'bulk=96,latency=32' (default: unbounded)")
    ap.add_argument("--priority-frac", type=float, default=0.0,
                    help="daemon mode: fraction of requests submitted on "
                         "the latency lane")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record request-lifecycle spans and write a "
                         "Chrome trace-event JSON to PATH")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    if args.daemon and args.rate <= 0:
        ap.error("--rate must be > 0 requests/second")
    if not 0.0 <= args.priority_frac <= 1.0:
        ap.error("--priority-frac must be in [0, 1]")
    if args.max_delay_ms is not None and args.max_delay_ms <= 0:
        ap.error("--max-delay-ms must be > 0")
    if not 0.0 <= args.markov_frac <= 1.0 or \
            not 0.0 <= args.evolve_frac <= 1.0:
        ap.error("--markov-frac and --evolve-frac must be in [0, 1]")
    if args.markov_frac > 0.0 or args.evolve_frac > 0.0 \
            or args.evolve_batch is not None:
        ap.error("--markov-frac > 0, --evolve-frac > 0 and --evolve-batch: "
                 "the Markov route is not ported to repro_torch yet "
                 "(ROADMAP queue 1 item 5)")
    if args.expm_frac > 1.0:
        ap.error("--expm-frac must not exceed 1")
    device = default_device("cpu" if args.interpret else args.device)
    sizes = [int(s) for s in args.sizes.split(",")]
    powers = [int(p) for p in args.powers.split(",")]
    dtypes = args.dtypes.split(",")
    unknown = [d for d in dtypes if d not in DTYPES]
    if unknown:
        ap.error(f"unknown dtypes {unknown}; expected some of "
                 f"{sorted(DTYPES)}")
    workload = make_workload(args.requests, sizes, powers, args.expm_frac,
                             args.seed, dtypes=dtypes, device=device)
    if args.daemon:
        return _daemon_main(args, workload, device)
    return _batch_main(args, workload, device)


if __name__ == "__main__":
    raise SystemExit(main())
