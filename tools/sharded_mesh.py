#!/usr/bin/env python3
"""The sharded chain on a mesh of several cards.

    python3 tools/sharded_mesh.py [--ranks 4] [--n 4096] [--device cuda]

Spawns ``--ranks`` processes, one card each (``nccl``; ``--device cpu``
runs the same on ``gloo``, at a small ``--n``, as a rehearsal), joined by a
``file://`` rendezvous, and runs ``matpow_sharded(a, 96)`` on the 2 x
(ranks/2) and 1 x ranks meshes of those ranks with each schedule that
applies (Cannon on square meshes only), in f32, bf16 and f64. For each
case rank 0 prints one JSON line:

  * the K1 launches of every rank: the dtype's K1 and nothing else, one a
    local product (7 for the gather schedule, 7 x cols for Cannon);
  * the largest error of the gathered answer against the single-device
    chain (``matpow_binary(a, 96, backend="cuda_chain")`` on the rank's own
    card) over every rank, held to ``error_budget(dtype, n, mults=7)``;
  * host ms of one ``matpow_sharded`` call (the result left sharded), the
    slowest rank's median over ``--reps`` calls each between two barriers
    and ending in a synchronise, beside the single-device chain's ms.

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

POWER, MULTS = 96, 7
DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def operand(n, dtype, device, seed):
    """Row-stochastic with distinct powers: (1 - 1/32) P + S / 32, P the
    permutation matrix of one random n-cycle, from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = rng.random((n, n)) + 0.05
    m = s / s.sum(-1, keepdims=True) / 32
    cycle = rng.permutation(n)
    m[cycle, np.roll(cycle, -1)] += 31 / 32
    return torch.from_numpy(m).to(device=device, dtype=dtype)


def rank_main(rank, world, rdzv, args):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import matpow_binary, matpow_sharded
    from repro_torch.kernels import error_budget
    from repro_torch.kernels import matmul_kernels as K

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(rdzv.removeprefix("file://")).parent / f"autotune_{rank}.json")
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=rdzv,
                            rank=rank, world_size=world,
                            **({"device_id": device} if cuda else {}))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def host_ms(fn):
        """The slowest rank's median ms of ``fn()`` over the reps."""
        times = []
        for _ in range(args.reps):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        t = torch.tensor([statistics.median(times)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def worst(x):
        t = torch.tensor([x], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    failed = 0
    try:
        for shape in ((2, world // 2), (1, world)):
            mesh = init_device_mesh(args.device, shape,
                                    mesh_dim_names=("data", "model"))
            algs = ("gather", "cannon") if shape[0] == shape[1] \
                else ("gather",)
            for i, dtype in enumerate(DTYPES):
                a = operand(args.n, dtype, device, 950 + i)
                want = matpow_binary(a, POWER, backend="cuda_chain")
                chain_ms = host_ms(lambda: matpow_binary(
                    a, POWER, backend="cuda_chain"))
                k1 = K.kernel_name("matmul", dtype) if cuda \
                    else "plain_matmul"
                for alg in algs:
                    sync()
                    before = K.launch_counts()
                    got = matpow_sharded(a, POWER, mesh, algorithm=alg)
                    sync()
                    after = K.launch_counts()
                    delta = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
                    expect = {k1: MULTS * (shape[1] if alg == "cannon"
                                           else 1)}
                    full = got.full_tensor()
                    rtol, atol = error_budget(dtype, n=args.n, mults=MULTS)
                    diff = (full.double() - want.double()).abs()
                    ok = bool(torch.allclose(full.double(), want.double(),
                                             rtol=rtol, atol=atol))
                    err = worst(float(diff.max()))
                    ok = worst(0.0 if ok and delta == expect else 1.0) == 0
                    failed += not ok
                    row = {"mesh": list(shape), "algorithm": alg,
                           "dtype": str(dtype).removeprefix("torch."),
                           "n": args.n, "ok": ok, "launches_rank": delta,
                           "expected_launches": expect,
                           "max_abs_err_vs_chain": err,
                           "sharded_ms": host_ms(lambda: matpow_sharded(
                               a, POWER, mesh, algorithm=alg)),
                           "cuda_chain_ms_one_card": chain_ms}
                    if rank == 0:
                        print(json.dumps(row), flush=True)
    finally:
        dist.destroy_process_group()
    if failed:
        raise SystemExit(f"rank {rank}: {failed} case(s) failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
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
