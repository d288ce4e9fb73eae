"""The child processes of ``tests/test_torch_distributed.py``.

    python tests/_torch_distributed_children.py reference IN.npz OUT.npz
    python tests/_torch_distributed_children.py port IN.npz OUT_DIR

``reference`` runs the JAX package's ``repro.core.distributed`` on a forced
4-device CPU (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set by
the caller) and writes its answers. ``port`` spawns a 4-rank ``gloo`` group
(a ``file://`` rendezvous, no TCP port) and runs ``repro_torch``'s sharded
chain and engine on its 2x2 and 1x4 meshes; every rank computes, every rank
gathers (a collective on one rank alone would hang the group), and rank 0
writes ``OUT_DIR/port.npz`` and ``OUT_DIR/port.json``. The inputs come from
the test module, made from numpy seeds, so both packages see the same bits.
"""

import json
import os
import sys
import tempfile

import numpy as np

#: (mesh shape, schedule) cases; Cannon runs on square meshes only.
MESH_ALGS = (((1, 1), "gather"), ((1, 1), "cannon"), ((1, 4), "gather"),
             ((2, 2), "gather"), ((2, 2), "cannon"))
POWERS = (0, 1, 2, 7, 96)
DTYPES = ("float32", "bfloat16")
N = 67


def key(shape, alg, dtype, p) -> str:
    return f"pow_{shape[0]}x{shape[1]}_{alg}_{dtype}_{p}"


# ---------------------------------------------------------------------------
# The reference (JAX)
# ---------------------------------------------------------------------------

def reference_main(inp_path, out_path) -> None:
    import jax
    import jax.numpy as jnp
    from repro.core import matmul_2d_gather, matmul_cannon, matpow_sharded

    def make_mesh(shape):
        # jax.sharding.AxisType exists on newer jax only (the reference
        # tests' shim).
        try:
            kinds = (jax.sharding.AxisType.Auto,) * 2
        except AttributeError:
            return jax.make_mesh(shape, ("data", "model"))
        return jax.make_mesh(shape, ("data", "model"), axis_types=kinds)

    inp = np.load(inp_path)
    out = {}
    mesh = make_mesh((2, 2))
    a, b = jnp.asarray(inp["a64"]), jnp.asarray(inp["b64"])
    out["gather_64"] = np.asarray(matmul_2d_gather(a, b, mesh))
    out["cannon_64"] = np.asarray(matmul_cannon(a, b, mesh))
    for shape, alg in MESH_ALGS:
        mesh = make_mesh(shape)
        for dtype in DTYPES:
            a = jnp.asarray(inp["a67"], getattr(jnp, dtype))
            for p in POWERS:
                got = matpow_sharded(a, p, mesh, algorithm=alg)
                out[key(shape, alg, dtype, p)] = np.asarray(got, np.float32)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# The port (torch.distributed, 4 ranks)
# ---------------------------------------------------------------------------

def _port_rank(rank, world, rdzv, inp_path, out_dir):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core import (ShardedMatmulChain, expm, expm_sharded,
                                  matmul_2d_gather, matmul_cannon,
                                  matpow_sharded, steady_state)
    from repro_torch.kernels import ops
    from repro_torch.serve import MatFnEngine
    from repro_torch.core.matpow import matpow_binary

    dist.init_process_group("gloo", init_method=rdzv, rank=rank,
                            world_size=world)
    try:
        inp = np.load(inp_path)
        out, facts = {}, {}
        meshes = {shape: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for shape in ((2, 2), (1, 4))}
        m22 = meshes[(2, 2)]

        a64 = torch.from_numpy(inp["a64"])
        b64 = torch.from_numpy(inp["b64"])
        out["gather_64"] = matmul_2d_gather(a64, b64, m22).full_tensor()
        out["cannon_64"] = matmul_cannon(a64, b64, m22).full_tensor()
        # DTensor operands: one placed otherwise is redistributed first; a
        # chain gathers a DTensor before it pads.
        replicated = distribute_tensor(a64, m22, [Replicate(), Replicate()])
        out["cannon_replicated"] = matmul_cannon(replicated, b64,
                                                 m22).full_tensor()
        sharded = matmul_2d_gather(a64, b64, m22)
        out["pow_of_dtensor"] = matpow_sharded(sharded, 3, m22).full_tensor()

        a67 = torch.from_numpy(inp["a67"])
        operands = {"float32": a67, "bfloat16": a67.to(torch.bfloat16),
                    "float64": a67.double()}
        for shape, alg in MESH_ALGS:
            if shape not in meshes:
                continue
            for dtype, a in operands.items():
                for p in POWERS:
                    got = matpow_sharded(a, p, meshes[shape], algorithm=alg)
                    out[key(shape, alg, dtype, p)] = got.full_tensor()
        try:
            matpow_sharded(a67, 2, meshes[(1, 4)], algorithm="cannon")
        except ValueError as exc:
            facts["cannon_1x4"] = str(exc)
        try:
            matmul_2d_gather(a67, a67, m22)
        except ValueError as exc:
            facts["uneven"] = str(exc)

        # One pad per chain, none at a divisible size.
        pads = []
        real_pad = ops.pad_to_blocks

        def counting(x, bm, bn):
            # Every ops.matmul asks; a call that pads returns a new tensor.
            out = real_pad(x, bm, bn)
            if out is not x:
                pads.append(tuple(x.shape))
            return out

        ops.pad_to_blocks = counting
        try:
            matpow_sharded(a67, 96, m22).full_tensor()
            facts["pads_67"] = len(pads)
            pads.clear()
            matpow_sharded(a64, 96, m22).full_tensor()
            facts["pads_64"] = len(pads)
        finally:
            ops.pad_to_blocks = real_pad

        # Donation: the squaring after next writes the consumed operand's
        # block; the caller's tensor is never written.
        keep = a64.clone()
        for alg in ("gather", "cannon"):
            chain = ShardedMatmulChain(64, torch.float32, m22, algorithm=alg)
            x = chain.pad(a64)
            y = chain.square(x)
            z = chain.square(y)
            facts[f"consumed_{alg}"] = \
                z.to_local().data_ptr() == x.to_local().data_ptr()
            out[f"square2_{alg}"] = chain.unpad(z).full_tensor()
        matpow_sharded(a64, 96, m22).full_tensor()
        facts["caller_kept"] = bool(torch.equal(a64, keep))

        # unpad in place (shard_multiple 1: shards of 34 = ceil(67 / 2))
        # and by gathering (16: shards of 48).
        for mult in (1, 16):
            chain = ShardedMatmulChain(N, torch.float32, m22,
                                       shard_multiple=mult)
            u = chain.unpad(chain.square(chain.pad(a67)))
            facts[f"unpad_{mult}"] = [chain.padded_n, list(u.shape),
                                      list(u.to_local().shape)]
            out[f"unpad_{mult}"] = u.full_tensor()

        s67 = torch.from_numpy(inp["s67"])
        out["expm_67"] = expm_sharded(s67, m22).full_tensor()
        out["expm_67_want"] = expm(s67)
        out["expm_60I"] = expm_sharded(60.0 * torch.eye(64), m22
                                       ).full_tensor()

        p45 = torch.from_numpy(inp["p45"])
        for mult in (1, 16):
            chain = ShardedMatmulChain(45, torch.float64, m22, donate=False,
                                       shard_multiple=mult)
            res = steady_state(p45, chain=chain)
            facts[f"steady_{mult}"] = int(res.squarings)
            out[f"steady_pi_{mult}"] = res.pi.full_tensor()
            out[f"steady_m_{mult}"] = res.matrix.full_tensor()

        # The engine in flush mode: every rank submits the same requests in
        # the same order.
        eng = MatFnEngine(device="cpu", mesh=m22, thresholds=(8, 48))
        e64 = torch.from_numpy(inp["e64"])
        mk = torch.from_numpy(inp["p64"])
        eng.submit("matpow", e64, power=7)
        eng.submit("expm", e64)
        eng.submit("markov", mk)
        eng.submit("matpow", e64[:8, :8], power=7)
        got = eng.flush()
        out["eng_matpow"], out["eng_expm"] = got[0], got[1]
        out["eng_pi"], out["eng_m"] = got[2].pi, got[2].matrix
        out["eng_small"] = got[3]
        out["eng_matpow_want"] = matpow_binary(e64, 7)
        out["eng_expm_want"] = expm(e64)
        want = steady_state(mk)
        out["eng_pi_want"], out["eng_m_want"] = want.pi, want.matrix
        facts["eng_squarings"] = [int(got[2].squarings),
                                  int(want.squarings)]
        facts["eng_routes"] = eng.stats()["routes"]
        daemon = MatFnEngine(device="cpu", mesh=m22)
        try:
            daemon.start()
        except ValueError as exc:
            facts["daemon"] = str(exc)
        facts["daemon_running"] = daemon.running

        if rank == 0:
            np.savez(os.path.join(out_dir, "port.npz"),
                     **{k: v.double().numpy() for k, v in out.items()})
            with open(os.path.join(out_dir, "port.json"), "w") as f:
                json.dump(facts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def port_main(inp_path, out_dir) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_port_rank, args=(4, f"file://{tmp}/rdzv", inp_path,
                                   out_dir), nprocs=4)


if __name__ == "__main__":
    what, inp_path, out = sys.argv[1:]
    if what == "reference":
        reference_main(inp_path, out)
    else:
        port_main(inp_path, out)
