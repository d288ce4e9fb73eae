"""The child processes of ``tests/test_torch_sharding.py``.

    python tests/_torch_sharding_children.py reference IN.npz OUT.npz
    python tests/_torch_sharding_children.py port IN.npz OUT_DIR

``reference`` runs the JAX package's ``compressed_psum`` and two
``ef_compress`` steps under one ``shard_map`` on a forced 4-device CPU
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by the caller)
and writes its answers. ``port`` spawns a 4-rank ``gloo`` group (a
``file://`` rendezvous, no TCP port) and runs ``repro_torch`` on its 2x2
``("data", "model")`` mesh: the same collectives, the Qwen3 smoke forward
from the reference's weights, one train step and greedy ``generate`` of
the qwen3 / mamba2 / mixtral smoke configs beside the same calls on one
device, and a checkpoint of the 2x2 state. Then ranks 0 and 1 form a
second group, restore that checkpoint onto a 1x2 mesh and compare it with
the state saved. Every rank computes and gathers (a collective on one rank
alone would hang the group); rank 0 writes ``OUT_DIR/port.npz`` and
``OUT_DIR/port.json``.
"""

import json
import os
import sys
import tempfile

import numpy as np

#: The smoke configs trained and served on the 2x2 mesh.
CONFIGS = ("qwen3-1.7b", "mamba2-130m", "mixtral-8x7b")
#: The qwen3 smoke config with int8 moments, trained on the 2x2 mesh too.
INT8 = "qwen3-1.7b-int8"
#: Placements of a (4, 6, 40) tensor on the 2x2 mesh taken to the int8
#: moments' row layout and back.
FLAT_CASES = {"shard_1_2": ("S1", "S2"), "shard_2_0": ("S2", "S0"),
              "nested_0": ("S0", "S0"), "replicate_shard": ("R", "S1"),
              "replicated": ("R", "R")}
#: Batch x sequence of the forward, the train step (2 microbatches) and
#: the prompt of ``generate``.
B, S = 4, 16
NEW_TOKENS = 6


# ---------------------------------------------------------------------------
# The reference (JAX)
# ---------------------------------------------------------------------------

def reference_main(inp_path, out_path) -> None:
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.parallel.collectives import compressed_psum, ef_compress

    try:        # jax.sharding.AxisType exists on newer jax only
        mesh = jax.make_mesh((4,), ("data",),
                             axis_types=(jax.sharding.AxisType.Auto,))
    except AttributeError:
        mesh = jax.make_mesh((4,), ("data",))
    x = np.load(inp_path)["x"]

    def f(xs):
        cp = compressed_psum(xs, "data")
        r1, e1 = ef_compress(xs, xs * 0.0, "data")
        r2, e2 = ef_compress(xs, e1, "data")
        return cp, r1, e1, r2, e2

    outs = shard_map(f, mesh=mesh, in_specs=P("data"),
                     out_specs=(P("data"),) * 5, check_rep=False)(x)
    np.savez(out_path, **{k: np.asarray(v) for k, v in
                          zip(("cp", "r1", "e1", "r2", "e2"), outs)})


# ---------------------------------------------------------------------------
# The port (torch.distributed, gloo)
# ---------------------------------------------------------------------------

def _unflatten(flat: dict) -> dict:
    tree = {}
    for name, arr in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _gather(obj):
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _batch(cfg, seed):
    import torch
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _names(placements) -> list:
    """Placements by name, as ``Shard(d)`` / ``Replicate`` (their ``str``
    differs between torch versions)."""
    return [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__
            for p in placements]


def _phase_2x2(rank, inp, out_dir, facts, out) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import convert
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     _flatten_with_names)
    from repro_torch.configs import get_config
    from repro_torch.kernels.matmul import launch_counts, reset_launches
    from repro_torch.launch.train import build
    from repro_torch.models import forward, init_params, unembed
    from repro_torch.models.layers import ShardCtx
    from repro_torch.parallel import sharding
    from repro_torch.parallel.collectives import compressed_psum, ef_compress
    from repro_torch.serve.engine import generate
    from repro_torch.train.optimizer import _leaves
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    sctx = ShardCtx(mesh=mesh)

    # -- compressed_psum / ef_compress over the 4 ranks --------------------
    xs = torch.from_numpy(inp["x"][rank:rank + 1].copy())
    cp = compressed_psum(xs, dist.group.WORLD)
    r1, e1 = ef_compress(xs, torch.zeros_like(xs), dist.group.WORLD)
    r2, e2 = ef_compress(xs, e1, dist.group.WORLD)
    for name, t in (("cp", cp), ("r1", r1), ("e1", e1), ("r2", r2),
                    ("e2", e2)):
        out[name] = np.concatenate([g.numpy() for g in _gather(t)])
    # 16 error-feedback steps against the exact sum (the reference test)
    err, total = torch.zeros_like(xs), torch.zeros_like(xs)
    for _ in range(16):
        r, err = ef_compress(xs, err, dist.group.WORLD)
        total += r
    out["ef16"] = total.numpy()

    # -- the Qwen3 smoke forward from the reference's weights --------------
    cfg = get_config("qwen3-1.7b", smoke=True)
    params = convert.params_from_reference(_unflatten(
        {k[2:]: inp[k] for k in inp.files if k.startswith("p/")}),
        device="cpu")
    spec = sharding.param_specs(params, cfg, mesh, "train")
    placed = sharding.place(params, sharding.named(mesh, spec))
    with torch.no_grad():
        logits = unembed(cfg, placed, forward(
            cfg, placed, torch.from_numpy(inp["tokens"]), sctx=sctx)["x"])
    out["fwd"] = logits.full_tensor().numpy()

    # -- a tensor in the int8 moments' row layout and back ---------------
    facts["flat_rows_mismatched"] = _flat_rows_cases(mesh)

    # -- one train step on 2x2 against one device --------------------------
    for arch in CONFIGS + (INT8,):
        cfg = get_config(arch.removesuffix("-int8"), smoke=True)
        if arch == INT8:
            cfg = cfg.replace(optimizer_state_dtype="int8")
        batch = _batch(cfg, 1)

        def state():
            return init_train_state(cfg, init_params(
                cfg, torch.Generator("cpu").manual_seed(0)))
        one = state()
        reset_launches()
        one, m1 = make_train_step(cfg, accum=2)(one, batch)
        n1 = launch_counts()["plain_matmul"]

        step, shardings = build(cfg, mesh=mesh, steps_total=10_000,
                                peak_lr=3e-4, accum=2)
        placed = sharding.place(state(), shardings)
        bsh = sharding.named(mesh, sharding.batch_specs(mesh, "lm"))
        b2 = {k: sharding.place(v, bsh[k]) for k, v in batch.items()}
        reset_launches()
        with CommDebugMode() as comm:
            placed, m2 = step(placed, b2)
        n2 = launch_counts()["plain_matmul"]
        diff = max(float((a.float() - _full(b).float()).abs().max())
                   for a, b in zip(_leaves(one["params"]),
                                   _leaves(placed["params"])))
        facts[arch] = {
            "one": {k: float(m1[k]) for k in ("loss", "ce", "grad_norm")},
            "mesh": {k: float(_full(m2[k]))
                     for k in ("loss", "ce", "grad_norm")},
            "param_diff": diff, "products_one": n1,
            "products_mesh": _gather(n2),
            "collectives": {str(k): v
                            for k, v in comm.get_comm_counts().items()}}
        if arch == INT8:
            # the stored moments: int8 codes and fp32 block scales
            ones = [x for m in ("m", "v") for x in _leaves(one["opt"][m])]
            mesh_ = [x for m in ("m", "v") for x in _leaves(placed["opt"][m])]
            facts[arch]["q_max_diff"] = max(
                int((a.q.int() - _full(b.q).int()).abs().max())
                for a, b in zip(ones, mesh_))
            facts[arch]["scale_max_rel"] = max(
                float(((a.scale - _full(b.scale)).abs()
                       / a.scale.abs()).max()) for a, b in zip(ones, mesh_))
            facts[arch]["q_placements"] = _names(mesh_[0].q.placements)
        if arch == CONFIGS[0]:
            # -- a checkpoint of the 2x2 state, and what it holds ----------
            ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))
            ckpt.save(1, placed)
            full = {k: _full(v).clone() for k, v in
                    _flatten_with_names(placed).items()}
            if rank == 0:
                torch.save(full, os.path.join(out_dir, "state_2x2.pt"))
            dist.barrier()

    # -- greedy generate on a 2x2 decode mesh against one device ----------
    for arch in CONFIGS:
        cfg = get_config(arch, smoke=True)
        params = init_params(cfg, torch.Generator("cpu").manual_seed(0))
        prompt = _batch(cfg, 2)["tokens"][:, :12]
        reset_launches()
        want = generate(cfg, params, prompt, max_new_tokens=NEW_TOKENS)
        n1 = launch_counts()["plain_matmul"]
        spec = sharding.param_specs(params, cfg, mesh, "decode")
        placed = sharding.place(params, sharding.named(mesh, spec))
        reset_launches()
        got = generate(cfg, placed, prompt, max_new_tokens=NEW_TOKENS,
                       sctx=sctx)
        facts[f"generate_{arch}"] = {
            "want": want.tolist(), "got": got.full_tensor().tolist(),
            "products_one": n1,
            "products_mesh": _gather(launch_counts()["plain_matmul"])}

    # -- an axis that does not divide its dim replicates -------------------
    odd = sctx.shard(torch.ones(3, 4), "data", "model")
    facts["odd_placements"] = _names(odd.placements)
    facts["odd_local_shape"] = list(odd.to_local().shape)


def _flat_rows_cases(mesh) -> list:
    """For each of ``FLAT_CASES``: the tensor in the row layout of its
    int8 blocks (rows over "data", as ``state_specs`` places them, and
    replicated) equals the rows of the whole tensor flattened; back again
    it is the tensor; ``QTensor.quantize`` / ``dequantize`` on the mesh
    equal one device's. Returns the cases (and checks) that differ."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.parallel.sharding import from_flat_rows, to_flat_rows
    from repro_torch.train.optimizer import QTensor

    x = torch.randn(4, 6, 40, generator=torch.Generator().manual_seed(3))
    one = QTensor.quantize(x)
    flat = torch.nn.functional.pad(x.reshape(-1), (0, one.q.numel()
                                                   - x.numel()))
    bad = []
    for rows_name, rows_pl in (("rows_data", [Shard(0), Replicate()]),
                               ("rows_replicated", [Replicate()] * 2)):
        like = QTensor(distribute_tensor(one.q, mesh, rows_pl),
                       distribute_tensor(one.scale, mesh, rows_pl),
                       one.shape, one.n)
        lo = like.q.to_local()
        first = (mesh.get_coordinate()[0] * lo.shape[0]
                 if rows_name == "rows_data" else 0)
        want_rows = flat.reshape(-1, lo.shape[1])[first:first + lo.shape[0]]
        for name, pl in FLAT_CASES.items():
            pl = [Replicate() if p == "R" else Shard(int(p[1:])) for p in pl]
            xd = distribute_tensor(x, mesh, pl)
            rows = to_flat_rows(xd, like.q)
            back = from_flat_rows(rows, like.q, xd)
            q = QTensor.quantize(xd, like)
            checks = {
                "rows": torch.equal(rows, want_rows),
                "back": torch.equal(back.to_local(), xd.to_local())
                and back.placements == xd.placements,
                "quantize": torch.equal(q.q.to_local(), lo) and torch.equal(
                    q.scale.to_local(), like.scale.to_local()),
                "dequantize": torch.equal(
                    q.dequantize(like=xd).full_tensor(), one.dequantize())}
            bad += [f"{rows_name}/{name}/{k}" for k, ok in checks.items()
                    if not ok]
    return bad


def _phase_1x2(rank, out_dir, facts) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     _flatten_with_names)
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(CONFIGS[0], smoke=True)
    _, shardings = build(cfg, mesh=mesh, steps_total=10_000, peak_lr=3e-4,
                         accum=2)
    saved = torch.load(os.path.join(out_dir, "state_2x2.pt"))
    template = _template(shardings)
    step, state = Checkpointer(os.path.join(out_dir, "ckpt")).restore(
        None, template, shardings=shardings)
    got = _flatten_with_names(state)
    facts["restore"] = {
        "step": step, "leaves": len(got),
        "mismatched": [k for k, v in got.items()
                       if not torch.equal(v.full_tensor(), saved[k])],
        "embed_placements": _names(state["params"]["embed"].placements),
        "embed_local_shape": list(
            state["params"]["embed"].to_local().shape)}


def _template(shardings):
    """Meta tensors shaped and typed like the train state of the smoke
    config: the restore's template, with the tree ``shardings`` has."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import _map
    from repro_torch.train.train_step import init_train_state

    cfg = get_config(CONFIGS[0], smoke=True)
    with FakeTensorMode():
        state = init_train_state(cfg, init_params(cfg, torch.Generator()))
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                      device="meta"), state)


def _port_rank(rank, world, tmp, inp_path, out_dir) -> None:
    import torch.distributed as dist
    inp = np.load(inp_path)
    facts, out = {}, {}
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv4",
                            rank=rank, world_size=world)
    try:
        _phase_2x2(rank, inp, out_dir, facts, out)
    finally:
        dist.destroy_process_group()
    if rank >= 2:
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdzv2",
                            rank=rank, world_size=2)
    try:
        _phase_1x2(rank, out_dir, facts)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **out)
        with open(os.path.join(out_dir, "port.json"), "w") as f:
            json.dump(facts, f)


def port_main(inp_path, out_dir) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_port_rank, args=(4, tmp, inp_path, out_dir), nprocs=4)


if __name__ == "__main__":
    what, inp_path, out = sys.argv[1:]
    if what == "reference":
        reference_main(inp_path, out)
    else:
        port_main(inp_path, out)
