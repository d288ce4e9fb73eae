#!/usr/bin/env python3
"""Where an LM decode step's time goes, on one GPU.

    python3 tools/profile_lm_decode.py [--arch qwen3-1.7b] [--batch 4]
                                       [--prompt 512] [--steps 16]

Serves ``--arch`` at its published width and depth with random weights
from a seed (``repro_torch.models.init_params``): one prefill of
``--batch`` x ``--prompt`` tokens, a few warm-up decode steps, then
``--steps`` greedy decode steps (``serve.engine.make_decode_fn``) timed on
the host clock (one synchronise at the end), then the same number under
``torch.profiler``. Prints one JSON line: host ms a step; the device's
busy ms a step (the time of its kernels and copies summed, operators'
rows left out, which repeat their kernels') and its share of the step;
K1's device ms a step (the kernels ``matmul_tc_kernel`` /
``matmul_kernel`` / ``matmul_wide_kernel``, launched through
``ops.dense_matmul``) and its share of
the busy time; the top kernels by device time and the top host-side
operators by self CPU time. Then the card's name and power limit. Needs a
CUDA device and ``nvcc``; imports ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import configs, models  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

K1_KERNELS = ("matmul_tc_kernel", "matmul_kernel", "matmul_wide_kernel",
              "matmul_dmma_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_decode.py needs a CUDA device", file=sys.stderr)
        return 1

    cfg = engine.serve_config(configs.get_config(args.arch))
    gen = torch.Generator("cuda").manual_seed(args.seed)
    params = models.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                         generator=gen, device="cuda")
    cache_len = args.prompt + 3 * args.steps + 8
    logits, cache = engine.prefill(cfg, params, toks, cache_len=cache_len)
    cast = model_lib._cast_params(cfg, params)
    dec = engine.make_decode_fn(cfg)

    def steps(n):
        nonlocal logits, cache
        for _ in range(n):
            tok = logits[:, -1].argmax(-1)[:, None]
            logits, cache = dec(cast, tok, cache)

    steps(4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels and copies only: an operator's row repeats its kernels' time
    device = [e for e in events if e.self_device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    k1_us = sum(e.self_device_time_total for e in device
                if any(name in e.key for name in K1_KERNELS))
    per = args.steps * 1e3
    print(json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": args.batch,
        "prompt": args.prompt, "steps": args.steps,
        "host_ms_per_step": host_ms,
        "device_busy_ms_per_step": busy_us / per,
        "device_busy_share": busy_us / per / host_ms,
        "k1_ms_per_step": k1_us / per,
        "k1_share_of_busy": k1_us / busy_us if busy_us else None,
        "top_kernels": [
            {"name": e.key[:90], "count_per_step": e.count / args.steps,
             "ms_per_step": e.self_device_time_total / per}
            for e in sorted(device,
                            key=lambda e: -e.self_device_time_total)[:10]],
        "top_host_ops": [
            {"name": e.key[:60], "count_per_step": e.count / args.steps,
             "self_cpu_ms_per_step": e.self_cpu_time_total / per}
            for e in sorted(events,
                            key=lambda e: -e.self_cpu_time_total)[:15]],
        "kernel_launches_per_step": sum(
            e.count for e in events if e.key == "cudaLaunchKernel")
        / args.steps,
    }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
