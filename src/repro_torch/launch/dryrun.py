"""Dry run: count every (arch x shape x mesh) cell from shapes alone.

The port of the reference's ``launch/dryrun.py``. Each cell is one step
(a train step, a prefill or a decode step) of a full-size config on a
production mesh, run on meta tensors: the state and batch are meta
DTensors placed by ``parallel.sharding`` on a fake process group of the
mesh's size (``torch.testing._internal.distributed.fake_pg``), made and
destroyed around the cell. No rank holds a weight and no device is used.
Rank 0's ops are counted by ``analysis.op_cost`` (FLOPs, bytes,
collectives, peak live bytes) and set against the H100's constants by
``analysis.roofline``.

Per cell:
    step at depths 4 and 6 (layer-pattern periods) under OpCounter
    -> extrapolated to the config's depth (``op_cost.extrapolate``)
    -> peak live bytes (fits 80 GB/GPU?)
    -> 3-term roofline (``analysis.roofline.analyze``)

The production mesh is made with the card's device type (``"cuda"``):
on a ``"cpu"`` mesh DTensor would replace each all-to-all by gloo's
all-gather fallback and count 16x the bytes NCCL moves. No CUDA call is
made; every tensor is on the meta device. The reference's
``_hoisted_upcast_bytes`` has no counterpart: it removes buffers that
XLA:CPU adds to a compiled TPU program, and here nothing is compiled.

Results are cached as JSON under experiments/dryrun_torch/ so the sweep is
resumable; --skip-existing continues an interrupted sweep. A cell that
raises is recorded as FAIL with its traceback, and the run then exits 1.

Usage:
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \
        --mesh single
    python -m repro_torch.analysis.summarize --dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import op_cost, roofline
from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,
                                 input_specs, shape_applicable)
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.layers import ShardCtx
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P
from repro_torch.serve.engine import make_decode_fn, prefill, serve_config
from repro_torch.train.train_step import init_train_state

__all__ = ["HBM_PER_CHIP", "choose_accum", "fake_group", "cut",
           "build_cell", "count_cell", "run_cell", "main"]

HBM_PER_CHIP = 80 * 1024**3          # H100 80GB
#: The production meshes by name: world size, and whether multi-pod.
MESHES = {"single": (256, False), "multi": (512, True)}
#: The depths (layer-pattern periods) a cell is traced at before
#: ``op_cost.extrapolate`` takes it to the config's depth. Not 1 and 2: a
#: shallow step's peak of live bytes falls at another point of the step
#: (the logits) than a deep one's (the accumulated stacked gradients,
#: from about 4 layers on); and both even, as the full depths are, since
#: DTensor resolves the stacked gradients along a dim it picks by the
#: depth's divisibility by the mesh's axes. Where the config's depth is a
#: multiple of a 16-wide axis (mixtral's 32 layers) the peak comes out
#: low (9 % for its train step); the other counts stay exact.
TRACED = (4, 6)


def choose_accum(global_batch: int, dp: int, want: int) -> int:
    """Largest accum <= want with (batch/accum) divisible by dp."""
    for a in range(min(want, global_batch), 0, -1):
        if global_batch % a == 0 and (global_batch // a) % dp == 0:
            return a
    return 1


def _dp_size(mesh):
    sizes = sharding.mesh_shape(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def _maybe_dp(mesh, dim: int):
    """dp axes tuple when the dim divides, else None (replicate)."""
    return dp_axes(mesh) if dim % _dp_size(mesh) == 0 else None


def _input_shardings(mesh, cfg, specs):
    out = {}
    for name, sds in specs.items():
        if name == "cache":
            out[name] = sharding.cache_partition_specs(sds, cfg, mesh)
        else:
            b = sds.shape[0]
            rest = (None,) * (len(sds.shape) - 1)
            out[name] = P(_maybe_dp(mesh, b), *rest)
    return out


@contextlib.contextmanager
def fake_group(world: int):
    """A default process group of ``world`` fake ranks (this process is
    rank 0): collectives return at once and move nothing. Destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def full_depth(cfg) -> int:
    """A config's depth in layer-pattern periods: its pattern's repeats
    (zamba2), else its layers."""
    return cfg.n_pattern_repeats if cfg.layer_pattern else cfg.n_layers


def cut(cfg, depth: int):
    """``cfg`` cut to ``depth`` layer-pattern periods: the repeats of a
    pattern (the tail layers kept), else the layers, an encoder's with
    them (whisper's encoder is as deep as its decoder). None when the
    config's stacks cannot be cut together."""
    if cfg.layer_pattern:
        return cfg.replace(n_pattern_repeats=depth,
                           n_layers=depth * len(cfg.layer_pattern)
                           + cfg.n_tail_layers)
    if cfg.encoder_layers and cfg.encoder_layers != cfg.n_layers:
        return None
    return cfg.replace(n_layers=depth,
                       encoder_layers=depth if cfg.encoder_layers else 0)


def _meta(tree):
    """Meta tensors of a tree of shapes (fake tensors or ``TensorSpec``)."""
    return sharding._map(lambda t: torch.empty(tuple(t.shape),
                                               dtype=t.dtype, device="meta"),
                         tree)


def _shapes(fn):
    """``fn()``'s tree as meta tensors, made under ``FakeTensorMode``: no
    memory, whatever the config's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = fn()
    return _meta(tree)


def _placed(mesh, tree, specs):
    return sharding.place(tree, sharding.named(mesh, specs))


def build_cell(arch: str, shape_name, mesh, *, sp: bool = False,
               overrides=None, cast_params: str = "step", depth=None):
    """(fn, args, cfg, shape): ``fn(*args)`` runs one step of the cell on
    meta DTensors placed on ``mesh`` (a ``DeviceMesh`` over the default
    process group); ``cfg`` is the cell's config at its full depth, and
    the step runs it cut to ``depth`` periods (``cut``) when ``depth`` is
    given. ``shape_name`` is a ``SHAPES`` key or a ``ShapeSpec``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    gen = torch.Generator("cpu")
    sctx = ShardCtx(mesh=mesh, dp=dp_axes(mesh), sp=sp)

    if shape.kind == "train":
        accum = choose_accum(shape.global_batch, _dp_size(mesh),
                             cfg.grad_accum)
        cfg = cfg.replace(grad_accum=accum)
        run = cfg if depth is None else cut(cfg, depth)
        kind, specs = input_specs(run, shape)
        step, shardings = train_launch.build(
            run, mesh=mesh, steps_total=10_000, peak_lr=3e-4, accum=accum,
            sp=sp, cast_params=cast_params)
        state = sharding.place(
            _shapes(lambda: init_train_state(run, init_params(run, gen))),
            shardings)
        batch = _placed(mesh, _meta(specs),
                        _input_shardings(mesh, run, specs))
        return step, (state, batch), cfg, shape

    cfg = serve_config(cfg).replace(param_dtype="bfloat16")
    if overrides:
        # re-apply: serve_config resets capacity_factor, and hillclimb
        # variants need to override the SERVING capacity too
        cfg = cfg.replace(**overrides)
    run = cfg if depth is None else cut(cfg, depth)
    kind, specs = input_specs(run, shape)
    params = _shapes(lambda: init_params(run, gen))
    params = _placed(mesh, params,
                     sharding.param_specs(params, run, mesh, "decode"))
    batch = _placed(mesh, _meta(specs), _input_shardings(mesh, run, specs))

    if kind == "prefill":
        def fn(params, batch):
            return prefill(run, params, batch["tokens"],
                           cache_len=shape.seq_len, sctx=sctx,
                           frames=batch.get("frames"),
                           vision_embeds=batch.get("vision_embeds"))
        return fn, (params, batch), cfg, shape

    decode = make_decode_fn(run, sctx=sctx)

    def fn(params, batch):
        return decode(params, batch["tokens"], batch["cache"])
    return fn, (params, batch), cfg, shape


def count_cell(arch: str, shape_name, mesh, *, sp: bool = False,
               overrides=None, cast_params: str = "step",
               fused_attention: bool = False):
    """(cost, cfg, shape): ``op_cost`` counts of one step of the cell on
    rank 0 of ``mesh``, at the config's full depth: traced at the depths
    ``TRACED`` (periods) and extrapolated, or traced whole when the config
    cannot be cut or is no deeper than them."""
    markers = op_cost.FUSED_ATTENTION_MARKERS if fused_attention else ()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    depth = full_depth(cfg)
    depths = (TRACED if depth > TRACED[1] and cut(cfg, 1) is not None
              else (None,))
    costs = []
    for d in depths:
        fn, args, cfg, shape = build_cell(
            arch, shape_name, mesh, sp=sp, overrides=overrides,
            cast_params=cast_params, depth=d)
        costs.append(op_cost.count(fn, *args, fused_markers=markers,
                                   depth=depth if d is None else d))
        del fn, args
        gc.collect()
    if len(costs) == 1:
        return costs[0], cfg, shape
    return op_cost.extrapolate(*costs, depth), cfg, shape


def _tag(arch, shape_name, mesh_name, variant) -> str:
    return f"{arch}__{shape_name}__{mesh_name}" + (
        "" if variant == "baseline" else f"__{variant}")


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path,
             *, sp: bool = False, verbose: bool = True,
             variant: str = "baseline", overrides=None,
             cast_params: str = "step", fused_attention: bool = False,
             mesh=None):
    """One cell, recorded as ``out_dir/<arch>__<shape>__<mesh>.json``:
    OK with its roofline, SKIP where ``shape_applicable`` says so, or FAIL
    with the traceback. The production mesh ``mesh_name`` is laid out on
    a fake group made for the cell; ``mesh`` (a ``DeviceMesh`` over a
    group the caller made) is used instead when given."""
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(get_config(arch), shape)
    path = out_dir / f"{_tag(arch, shape_name, mesh_name, variant)}.json"
    tag = path.stem
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "SKIP", "reason": why}
        path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({why.split(';')[0]})")
        return rec

    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            if mesh is None:
                world, multi = MESHES[mesh_name]
                stack.enter_context(fake_group(world))
                mesh = make_production_mesh(multi_pod=multi, device="cuda")
            cost, cfg, shape = count_cell(
                arch, shape_name, mesh, sp=sp, overrides=overrides,
                cast_params=cast_params, fused_attention=fused_attention)
            n_devices = mesh.size()
        t_count = time.time() - t0
        rep = roofline.analyze(
            arch=arch, shape_name=shape_name, mesh_name=mesh_name,
            n_devices=n_devices, cost=cost, cfg=cfg, shape=shape)
        live = cost.peak_bytes
        rec = rep.to_dict()
        rec.update(status="OK", live_bytes_per_device=live,
                   fits_80gb=bool(live <= HBM_PER_CHIP),
                   depths=list(cost.depths), count_s=round(t_count, 1),
                   variant=variant)
        path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[dryrun] {tag}: OK  dom={rec['dominant']:10s} "
                  f"compute={rec['compute_s']*1e3:8.2f}ms "
                  f"mem={rec['memory_s']*1e3:8.2f}ms "
                  f"coll={rec['collective_s']*1e3:8.2f}ms "
                  f"useful={rec['useful_ratio']:.2f} "
                  f"live={live/2**30:.2f}GiB fits={rec['fits_80gb']} "
                  f"({t_count:.0f}s count)")
        return rec
    except Exception as e:  # record failures — they are bugs to fix
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {str(e)[:200]}")
        return rec
    finally:
        gc.collect()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel activations")
    ap.add_argument("--variant", default="baseline",
                    help="label for hillclimb variants (suffixes the JSON)")
    ap.add_argument("--override", action="append", default=[],
                    help="ArchConfig overrides, e.g. remat_policy=dots")
    ap.add_argument("--cast-params", default="step",
                    choices=["step", "microbatch"])
    ap.add_argument("--fused-attention", action="store_true",
                    help="roofline model of a fused attention kernel "
                         "(scores kept on chip: no HBM bytes inside the "
                         "attention cores)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v

    archs = list(ARCH_NAMES) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = n_skip = 0
    t0 = time.time()
    for mesh_name in meshes:
        for arch in archs:
            for shape_name in shapes:
                path = out_dir / (_tag(arch, shape_name, mesh_name,
                                       args.variant) + ".json")
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("OK", "SKIP"):
                        continue
                rec = run_cell(arch, shape_name, mesh_name, out_dir,
                               sp=args.sp, variant=args.variant,
                               overrides=overrides or None,
                               cast_params=args.cast_params,
                               fused_attention=args.fused_attention)
                st = rec.get("status")
                n_ok += st == "OK"
                n_fail += st == "FAIL"
                n_skip += st == "SKIP"
    print(f"[dryrun] done: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"in {time.time() - t0:.0f}s")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
