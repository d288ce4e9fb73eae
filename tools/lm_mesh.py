#!/usr/bin/env python3
"""The LM on a mesh of several cards.

    python3 tools/lm_mesh.py [--ranks 4] [--device cuda]
    python3 tools/lm_mesh.py --device cpu       # gloo rehearsal, smoke size

Spawns ``--ranks`` processes, one card each (``nccl``; ``--device cpu``
runs the same on ``gloo`` with the smoke config at 4 x 16 tokens in 2
microbatches, as a rehearsal), joined by a ``file://`` rendezvous, on a
(ranks/2) x 2 ``("data", "model")`` mesh (FSDP over data, TP over model).
Rank 0 prints one JSON line for each of:

  * ``one_card``: rank 0 alone takes one train step of ``--arch`` (phase
    train's batch: 8 x 512 tokens in 4 microbatches, remat "nothing") from
    a seeded state, then a second step timed: loss, ce, grad norm, K1
    launches, ms a step, peak GB;
  * ``mesh_train``: the same state and batch placed on the mesh
    (``launch.train.build(mesh=...)``): the same numbers for every rank,
    each rank's K1 launches (the dtype's K1 and nothing else, exactly the
    one card's count), the collectives by kind (``CommDebugMode``) and
    each rank's peak GB; loss, ce, grad norm and the norm of the
    parameters' change in the step held to the one card's under
    ``DENSE_BUDGET["bfloat16"]`` (``"float32"`` on the CPU), and the
    change itself, leaf by leaf, within ``CHANGE_BOUND`` of the one card's
    in relative norm, with the share of coordinates whose step moved the
    other way (AdamW's first step is lr times the gradient's sign, so
    noise flips only coordinates whose gradient is near zero, while a step
    on other data flips a large share);
  * ``compressed_psum``: ``compressed_psum`` / ``ef_compress`` over all
    ranks on a seeded (ranks, 2^20) input, one row a rank, against the
    exact fp32 sum under the reference test's bounds (2e-2 one-shot, 5e-3
    after 16 error-feedback steps), and host ms beside an fp32 all-reduce.

Then the card's name and power limit. Exits non-zero if a check fails.
Imports ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PSUM_N = 1 << 20
#: The largest relative norm of (mesh change - one card's change) in the
#: first step: a step of lr * sign(g) flipped on a share f of the
#: coordinates differs by 2 * sqrt(f), so 0.5 admits f up to 6 %, where
#: rounding noise flips far fewer and a step on half the batch about a
#: quarter (relative norm near 1).
CHANGE_BOUND = 0.5


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def rank_main(rank, world, rdzv, args):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels import fastmm
    from repro_torch.kernels import matmul_kernels as K
    from repro_torch.launch.train import build
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import compressed_psum, ef_compress
    from repro_torch.train.train_step import init_train_state

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(rdzv.removeprefix("file://")).parent / f"autotune_{rank}.json")
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=rdzv,
                            rank=rank, world_size=world,
                            **({"device_id": device} if cuda else {}))
    cfg = get_config(args.arch, smoke=not cuda)
    batch, seq, accum = (8, 512, 4) if cuda else (4, 16, 2)
    k1 = K.kernel_name("matmul", torch.bfloat16 if cfg.compute_dtype
                       == "bfloat16" else torch.float32) if cuda \
        else "plain_matmul"
    rtol, atol = fastmm.DENSE_BUDGET[cfg.compute_dtype]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def state():
        params = init_params(cfg, torch.Generator(device).manual_seed(
            args.seed))
        return init_train_state(cfg, params)

    def launches():
        return {k: v for k, v in K.launch_counts().items() if v}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix[:-1], tree

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    data = next(SyntheticStream(cfg, seed=args.seed + 1, batch=batch,
                                seq=seq, device=device))
    failed = []
    try:
        # ---- one card ----------------------------------------------------
        one = None
        if rank == 0:
            step, _ = build(cfg, steps_total=1000, peak_lr=3e-4,
                            accum=accum)
            st = state()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            before = {k: v.detach().to("cpu", torch.float32, copy=True)
                      for k, v in leaves(st["params"])}
            K.reset_launches()
            (st, m), ms0 = timed(lambda: step(st, data))
            count = launches()
            if set(count) != {k1}:
                failed.append("one_card")
            one_change = {k: v.detach().float().cpu() - before.pop(k)
                          for k, v in leaves(st["params"])}
            ms = timed(lambda: step(st, data))[1]
            one = {"arch": cfg.name, "batch": batch, "seq": seq,
                   "accum": accum, "k1_launches": count,
                   **{k: float(m[k]) for k in ("loss", "ce", "grad_norm")},
                   "ms_first_step": ms0, "ms_per_step": ms,
                   "peak_gb": peak_gb()}
            del st
            print(json.dumps({"line": "one_card", **one}), flush=True)
            if cuda:
                torch.cuda.empty_cache()
        box = [one]
        dist.broadcast_object_list(box, src=0)
        one = box[0]

        # ---- the mesh ----------------------------------------------------
        mesh = init_device_mesh(args.device, (world // 2, 2),
                                mesh_dim_names=("data", "model"))
        step, shardings = build(cfg, mesh=mesh, steps_total=1000,
                                peak_lr=3e-4, accum=accum)
        st = sharding.place(state(), shardings)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        placed = sharding.named(mesh, sharding.batch_specs(mesh, "lm"))
        b2 = {k: sharding.place(v, placed[k]) for k, v in data.items()}
        before = {k: v.detach().clone() for k, v in leaves(st["params"])}
        K.reset_launches()
        with CommDebugMode() as comm:
            (st, m), ms0 = timed(lambda: step(st, b2))
        count = launches()
        # the change of each leaf, gathered leaf by leaf, against rank 0's
        # one-card change: sums of squares and the coordinates moved the
        # other way (a difference above lr, where each step is about lr)
        sq = {"one": 0.0, "mesh": 0.0, "diff": 0.0}
        flipped = coords = 0
        lr = float(_full(m["lr"]))
        for k, v in leaves(st["params"]):
            d = _full(v.detach() - before.pop(k)).float().cpu()
            if rank == 0:
                o = one_change.pop(k)
                sq["one"] += float(o.double().square().sum())
                sq["mesh"] += float(d.double().square().sum())
                sq["diff"] += float((d - o).double().square().sum())
                flipped += int(((d - o).abs() > lr).sum())
                coords += d.numel()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()                       # rank 0 compared on the host
        ms = timed(lambda: step(st, b2))[1]
        metrics = {k: float(_full(m[k])) for k in ("loss", "ce",
                                                   "grad_norm")}
        ranks = [None] * world
        dist.all_gather_object(ranks, {"k1_launches": count,
                                       "peak_gb": peak_gb(),
                                       "ms_per_step": ms})
        ok = all(r["k1_launches"] == one["k1_launches"] for r in ranks)
        ok &= all(abs(metrics[k] - one[k]) <= atol + rtol * abs(one[k])
                  for k in metrics)
        change = None
        if rank == 0:
            n_one, n_mesh = sq["one"] ** 0.5, sq["mesh"] ** 0.5
            change = {"norm_one_card": n_one, "norm_mesh": n_mesh,
                      "rel_diff": (sq["diff"] ** 0.5 / n_one if n_one
                                   else float("inf")),
                      "bound": CHANGE_BOUND, "flipped_share": flipped / coords}
            change["ok"] = (n_one > 0 and abs(n_mesh - n_one)
                            <= atol + rtol * n_one
                            and change["rel_diff"] <= CHANGE_BOUND)
        box = [change]
        dist.broadcast_object_list(box, src=0)
        change = box[0]
        ok &= change["ok"]
        if not ok:
            failed.append("mesh_train")
        if rank == 0:
            print(json.dumps({
                "line": "mesh_train", "mesh": [world // 2, 2], "ok": ok,
                **metrics, "one_card": {k: one[k] for k in metrics},
                "param_change": change,
                "rtol": rtol, "atol": atol, "ms_first_step": ms0,
                "ms_per_step_slowest": max(r["ms_per_step"] for r in ranks),
                "tokens_per_s": batch * seq / max(
                    r["ms_per_step"] for r in ranks) * 1e3,
                "collectives": {str(k): v for k, v in
                                comm.get_comm_counts().items()},
                "ranks": ranks}), flush=True)
        del st, b2

        # ---- compressed_psum / ef_compress over every rank ---------------
        rng = np.random.default_rng(args.seed)
        rows = torch.from_numpy(rng.standard_normal(
            (world, PSUM_N)).astype(np.float32)).to(device)
        x = rows[rank:rank + 1].clone()
        exact = rows.sum(0, keepdim=True)
        got = compressed_psum(x, None)
        one_shot = float((got - exact).abs().max() / exact.abs().max())
        err, total = torch.zeros_like(x), torch.zeros_like(x)
        for _ in range(16):
            r, err = ef_compress(x, err, None)
            total += r
        ef = float((total - 16 * exact).abs().max()
                   / (16 * exact).abs().max())

        def host_ms(fn, reps=5):
            times = []
            for _ in range(reps):
                dist.barrier()
                _, t = timed(fn)
                times.append(t)
            return statistics.median(times)

        def fp32_all_reduce():
            y = x.clone()
            dist.all_reduce(y)
            return y
        ok = one_shot < 2e-2 and ef < 5e-3
        if not ok:
            failed.append("compressed_psum")
        row = {"line": "compressed_psum", "ranks": world, "n": PSUM_N,
               "ok": ok, "rel_err_one_shot": one_shot,
               "rel_err_ef_16_steps": ef,
               "compressed_psum_ms": host_ms(
                   lambda: compressed_psum(x, None)),
               "fp32_all_reduce_ms": host_ms(fp32_all_reduce)}
        if rank == 0:
            print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    if failed:
        raise SystemExit(f"rank {rank}: {failed} failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.ranks < 2 or args.ranks % 2:
        ap.error("--ranks must be even and at least 2")
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(args.ranks, f"file://{tmp}/rdzv", args),
                 nprocs=args.ranks)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
