#!/usr/bin/env python3
"""Where an LM training step's time goes, on one GPU.

    python3 tools/profile_lm_train.py [--arch qwen3-1.7b] [--batch 8]
                                      [--seq 512] [--accum 4] [--steps 2]

Trains ``--arch`` at its published width and depth from random weights
(``repro_torch.models.init_params`` from ``--seed``) on ``SyntheticStream``
batches with ``train.train_step.make_train_step`` (fp32 masters and
moments, the compute dtype's copy cast once a step, remat as the config
says): one warm-up step, ``--steps`` steps timed on the host clock (each
ending in a synchronise), then one step under ``torch.profiler``. Prints
one JSON line: host ms a step, tokens/s, peak GB allocated; the device's
busy ms in the profiled step (its kernels and copies summed, operators'
rows left out) and its share of the step; K1's device ms
(``matmul_tc_kernel`` / ``matmul_kernel`` / ``matmul_wide_kernel``:
every projection's forward, recomputation, dx and dw) and its share of
the busy time, with its launch count; the device ms of copies and
casts (the transposing copies ``ops.matmul`` makes among them); the top
kernels by device time
and the top host-side operators by self CPU time (a layer's recomputation
runs inside the backward of its first product to need a saved tensor, so
that ``_Dense2dBackward`` row holds the Python time of the recomputed
forward); and the host-device synchronisations of one more step
(``torch.cuda.set_sync_debug_mode``), counted by the line that made them.
Then the card's name and power limit. Needs a CUDA device and ``nvcc``;
imports ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs, models  # noqa: E402
from repro_torch.data.synthetic import SyntheticStream  # noqa: E402
from repro_torch.kernels import matmul_kernels as K  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

K1_KERNELS = ("matmul_tc_kernel", "matmul_kernel", "matmul_wide_kernel",
              "matmul_dmma_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_train.py needs a CUDA device", file=sys.stderr)
        return 1

    cfg = configs.get_config(args.arch)
    state = init_train_state(cfg, models.init_params(
        cfg, torch.Generator("cuda").manual_seed(args.seed)))
    stream = SyntheticStream(cfg, seed=args.seed + 1, batch=args.batch,
                             seq=args.seq)
    step = make_train_step(cfg, accum=args.accum)

    def one():
        nonlocal state
        state, metrics = step(state, next(stream))
        return metrics

    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        metrics = one()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = min(host)

    from torch.profiler import ProfilerActivity, profile
    K.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    k1_launches = sum(v for k, v in K.launch_counts().items()
                      if not k.startswith("plain"))
    syncs = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            syncs[f"{Path(w.filename).name}:{w.lineno}"] += 1
    events = prof.key_averages()
    # kernels and copies only: an operator's row repeats its kernels' time
    device = [e for e in events if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)

    def device_ms(pred):
        return sum(e.self_device_time_total for e in device
                   if pred(e.key)) / 1e3

    k1_ms = device_ms(lambda k: any(n in k for n in K1_KERNELS))
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
        "seq": args.seq, "accum": args.accum,
        "remat": cfg.remat and cfg.remat_policy,
        "host_ms_per_step": host_ms, "host_ms_all": host,
        "tokens_per_s": args.batch * args.seq / host_ms * 1e3,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss": float(metrics["loss"]),
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / host_ms,
        "k1_ms": k1_ms, "k1_launches": k1_launches,
        "k1_share_of_busy": k1_ms * 1e3 / busy_us if busy_us else None,
        "copy_ms": device_ms(lambda k: "copy" in k.lower()
                             or "Memcpy" in k),
        "top_kernels": [
            {"name": e.key[:90], "count": e.count,
             "ms": e.self_device_time_total / 1e3}
            for e in sorted(device,
                            key=lambda e: -e.self_device_time_total)[:15]],
        "top_host_ops": [
            {"name": e.key[:60], "count": e.count,
             "self_cpu_ms": e.self_cpu_time_total / 1e3}
            for e in sorted(events,
                            key=lambda e: -e.self_cpu_time_total)[:15]],
        "kernel_launches": sum(e.count for e in events
                               if e.key == "cudaLaunchKernel"),
        "syncs": dict(syncs.most_common(10)),
    }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
