"""Training driver: data -> train step -> checkpoint, with the
fault-tolerance runtime wired in.

    python -m repro_torch.launch.train --arch mamba2-130m --smoke \
        --steps 50 --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \
        --steps 200 --batch 16 --seq 256 --ckpt-dir /tmp/ck --ckpt-every 50

Runs on the card unless ``--device cpu`` is given (and raises when the
card is asked for and there is none). Restart-ability: rerun the same
command after killing it — the driver resumes from the latest checkpoint
(params, optimizer, data position).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import default_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import init_params
from repro_torch.models.layers import ShardCtx, NO_SHARD
from repro_torch.parallel import sharding
from repro_torch.runtime.fault import Watchdog, retry_step
from repro_torch.train.optimizer import _leaves
from repro_torch.train.train_step import init_train_state, make_train_step


def build(cfg, *, mesh=None, steps_total: int, peak_lr: float, accum: int,
          sp: bool = False, cast_params: str = "step"):
    """(step function, shardings): the train step of ``cfg``.

    Without a mesh the shardings are ``None``. On a ``DeviceMesh`` the step
    runs on DTensors with a ``ShardCtx`` over ``dp_axes(mesh)`` (``sp``:
    sequence-parallel activations), and the shardings are the state's
    placements (``state_specs(..., "train")`` through ``named``), worked
    out on shapes alone; the caller places its state with them
    (``parallel.sharding.place``). ``cast_params`` is
    ``make_train_step``'s."""
    sctx = (ShardCtx(mesh=mesh, dp=dp_axes(mesh), sp=sp)
            if mesh is not None else NO_SHARD)
    step_fn = make_train_step(cfg, sctx=sctx, total_steps=steps_total,
                              peak_lr=peak_lr, accum=accum,
                              cast_params=cast_params)
    if mesh is None:
        return step_fn, None
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator("cpu")
    with FakeTensorMode():                   # shapes, no memory
        state_shape = init_train_state(cfg, init_params(cfg, gen))
    spec = sharding.state_specs(state_shape, cfg, mesh, "train")
    return step_fn, sharding.named(mesh, spec)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    step_fn, _ = build(cfg, steps_total=args.steps, peak_lr=args.lr,
                       accum=args.accum)

    params = init_params(cfg, torch.Generator(device).manual_seed(args.seed))
    state = init_train_state(cfg, params)
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[train] {cfg.name} on {device.type}: {n_params/1e6:.1f}M "
          f"params, {args.steps} steps, batch {args.batch} x seq {args.seq}")

    stream = SyntheticStream(cfg, seed=args.seed, batch=args.batch,
                             seq=args.seq, device=device)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start, state = ckpt.restore(None, state)
        stream.step = start
        print(f"[train] resumed from step {start}")

    dog = Watchdog()
    t_begin = time.time()
    for i in range(start, args.steps):
        batch = next(stream)
        t0 = time.time()
        state, metrics = retry_step(step_fn, state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        ev = dog.observe(i, dt)
        if ev is not None:
            print(f"[train] WARNING {ev}")
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"[train] step {i:5d} loss {metrics['loss']:.4f} "
                  f"ce {metrics['ce']:.4f} gnorm {metrics['grad_norm']:.3f} "
                  f"lr {metrics['lr']:.2e} ({dt*1e3:.0f} ms)")
        if ckpt is not None and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state, blocking=False)
    if ckpt is not None:
        ckpt.save(args.steps, state, blocking=True)
    total = time.time() - t_begin
    print(f"[train] done: {args.steps - start} steps in {total:.1f}s "
          f"({(args.steps - start) / max(total, 1e-9):.2f} steps/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
