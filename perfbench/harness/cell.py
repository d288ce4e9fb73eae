"""One run of one cell: set-up, the measured window, the readings, the
check against the reference, and the result line.

The window drives ``repro_torch.serve.matfn.MatFnEngine``: in daemon mode
(``start()``, futures) for a one-chip cell, in synchronous mode
(``submit`` + ``flush`` on every rank) on a mesh. Nothing here calls a
kernel or a chain of the port directly.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import time

import torch

from perfbench.harness import clients, trace, work
from perfbench.harness.stats import percentile
from perfbench.harness.traffic import client_requests

__all__ = ["Readings", "run", "FORBIDDEN", "forbidden_modules"]

#: Top-level module names that may not be loaded in a run: JAX, its
#: libraries, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: Client ids of the warm round's request streams (apart from the window's).
WARM_CLIENT = 1 << 20


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is in :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``). The
    engine's request and bucket counts, its stage sums and each answer's
    time inside ``submit`` have no reader among today's card-bound cells;
    they are here so that a host-bound cell's metrics (bucket occupancy,
    queue wait, host time a bucket) can be added as readers alone, since
    a later change may add files here but not edit this one."""
    op: str
    mode: str                 # "daemon" or "mesh"
    submitted: int            # requests submitted in the window
    in_window: list           # clients.Done of answers inside the window
    traced: list              # clients.Done of answers inside the profile
    multiplies: list          # dense multiplies of each ``traced`` answer
    counters: dict            # engine and launch counter deltas
    summary: object           # trace.Summary, or None without --trace 1
    work_bound_s: float       # least card time for the ``traced`` answers


def _stage_totals(engine) -> dict:
    out = {}
    for stage in ("queue", "assemble", "resolve"):
        h = engine.metrics.merged("stage", stage=stage)
        out[stage] = (h.count, h.sum)
    return out


def _counters(engine) -> dict:
    from repro_torch.kernels import matmul_kernels
    snap = engine.stats()
    return {"requests": snap["requests"], "buckets": snap["buckets"],
            "launches": sum(matmul_kernels.launch_counts().values()),
            "stages": _stage_totals(engine)}


def _delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in ("requests", "buckets",
                                             "launches")}
    out["stages"] = {s: (after["stages"][s][0] - before["stages"][s][0],
                         after["stages"][s][1] - before["stages"][s][1])
                     for s in after["stages"]}
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm(engine, op, mix, mode, seed, device) -> None:
    """Every shape the cell's traffic uses, then one round of real
    requests, one per client, through the same path as the window."""
    batches = [1] if mode == "mesh" else \
        [b for b in (1, 2, 4, 8, 16, 32, 64)
         if b <= min(mix["clients"], engine.max_batch)]
    for name, n, dtype, power in op.warm_classes(mix):
        engine.warm(name, n, dtype, power=power, batches=batches)
    firsts = [next(client_requests(mix, seed, WARM_CLIENT + c))
              for c in range(1 if mode == "mesh" else mix["clients"])]
    if mode == "mesh":
        op.submit(engine, firsts[0])
        engine.flush()
    else:
        for fut in [op.submit(engine, r) for r in firsts]:
            fut.result(timeout=clients.RESULT_TIMEOUT_S)
    _sync(device)


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, mesh=None, rank: int = 0, world: int = 1) -> dict:
    """Run one cell on this process's device (on a mesh: this rank's part).
    Returns the result line (on a mesh the other ranks get None) and the
    checked numbers as ``result["checks"]``; on a mesh, the modules of
    :data:`FORBIDDEN` that another rank loaded, by rank, as
    ``result["forbidden_elsewhere"]`` (absent when there are none)."""
    from repro_torch.serve import MatFnEngine

    config, mix = cell.config, cell.mix
    mode = mix["mode"]
    op = importlib.import_module(f"perfbench.ops.{config['op']}").Op(
        config, mix, seed, device)
    engine = MatFnEngine(device=device, mesh=mesh)
    if mode == "daemon":
        engine.start()
    _warm(engine, op, mix, mode, seed, device)
    if mode == "mesh":
        import torch.distributed as dist
        dist.barrier()
    before = _counters(engine)
    setup_s = time.perf_counter() - t_start
    window = trace.Window(traced)
    if mode == "daemon":
        logs, w0, w1 = clients.daemon_window(engine, op, mix, seed, seconds,
                                             on_close=window.close)
    else:
        logs, w0, w1 = clients.mesh_window(engine, op, mix, seed, seconds,
                                           device, on_close=window.close)
    window.close()
    _sync(device)
    counters = _delta(before, _counters(engine))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    summary = None if window.prof is None else trace.summarize(
        window.prof, device.index if device.type == "cuda" else None)
    window = None
    engine.close()
    done = [d for log in logs for d in log.done]
    in_window = [d for d in done if d.t_done <= w1]
    # On a mesh the profile runs to the last request, past the window.
    traced_done = done if mode == "mesh" else in_window
    multiplies = [op.multiplies(d.req, d.token) for d in traced_done]
    n_of = [d.req.n for d in traced_done]
    bound = sum(work.dense_bound_s(n, op.dtype_name, m, 1.0 / world)
                for n, m in zip(n_of, multiplies))
    readings = Readings(config["op"], mode,
                        sum(log.attempted for log in logs), in_window,
                        traced_done, multiplies, counters, summary, bound)
    failed = sum(log.failed for log in logs)
    errors = [e for log in logs for e in log.errors][:3]
    samples = [s for log in logs for s in log.samples]
    longest = max((log.longest for log in logs if log.longest is not None),
                  key=lambda x: x[0], default=None)
    if longest is not None and all(r is not longest[1] for r, _ in samples):
        samples.append((longest[1], longest[2]))

    stats = _gather(device, world, peak, summary)
    del engine, logs, done, traced_done
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    lat_ms = [(d.t_done - d.t_submit) * 1e3 for d in in_window]
    metrics = {}
    if not traced:
        values = {"requests_per_s": len(in_window) / (w1 - w0),
                  "latency_p50_ms": percentile(lat_ms, 50) if lat_ms
                  else None,
                  "latency_p95_ms": percentile(lat_ms, 95) if lat_ms
                  else None,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from perfbench.harness.spec import metric_reader
        for m in cell.per_layer:
            value = metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = op.numbers(samples) if samples else {}
    checks = {"failed_requests": {"value": failed, "limit": 0},
              "checked_answers": {"value": len(samples), "limit": 1,
                                  "at_least": True}}
    for name, lim in cell.limits.items():
        checks[name] = {"value": numbers.get(name, float("inf")),
                        "limit": lim["limit"]}
    correct = (failed == 0 and len(samples) >= 1 and len(in_window) >= 1
               and all(checks[name]["value"] <= checks[name]["limit"]
                       for name in cell.limits))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": world, "memory_peak_bytes": stats["peak"]}
    result = {"correct": bool(correct),
              "attempted": readings.submitted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = stats["busy_s"]
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    if errors:
        result["errors"] = errors
    if stats["forbidden"]:
        result["forbidden_elsewhere"] = stats["forbidden"]
    result["checks"] = checks
    return result


def _gather(device, world: int, peak: int, summary) -> dict:
    """The fullest card's peak, the card-averaged busy time and the
    forbidden modules each other rank has loaded, by rank (on a mesh, by
    collectives over the ranks once the window has closed; else this
    card's, and no other rank)."""
    busy = 0.0 if summary is None else summary.busy_s
    if world == 1:
        return {"peak": int(peak), "busy_s": busy, "forbidden": {}}
    import torch.distributed as dist
    t = torch.tensor([float(peak)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    b = torch.tensor([busy], dtype=torch.float64, device=device)
    dist.all_reduce(b, op=dist.ReduceOp.SUM)
    found = [None] * world
    dist.all_gather_object(found, forbidden_modules())
    return {"peak": int(t.item()), "busy_s": b.item() / world,
            "forbidden": {r: names for r, names in enumerate(found)
                          if r != dist.get_rank() and names}}
