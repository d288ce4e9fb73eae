"""``repro_torch.parallel`` / ``launch.mesh`` / ``ShardCtx`` against the
reference's ``parallel/sharding.py``, ``collectives.py`` and its sharded
LM, on the CPU.

(a) Spec parity, with no devices: the placement rules of the ten configs
at full size, in ``"train"`` and ``"decode"``, on the 16x16 and 2x16x16
production meshes. The shapes are the reference's (``jax.eval_shape``),
handed to the port as ``meta`` tensors; the reference's mesh is an
``AbstractMesh`` (as ``tests/test_sharding.py`` builds it), the port's
``make_production_mesh(device="cpu")`` on a fake 256 / 512-rank process
group that a fixture creates and destroys around each test.

(b) The mesh itself, in two children started together when this module
starts (``tests/_torch_sharding_children.py``): a JAX child on a forced
4-device CPU runs the reference's ``compressed_psum`` / ``ef_compress``,
and a 4-rank ``gloo`` child (``file://`` rendezvous: no TCP port) runs the
port on a 2x2 mesh: the same collectives, the Qwen3 smoke forward, one
train step and greedy ``generate`` of three smoke configs beside the same
calls on one device, and a checkpoint saved on 2x2 and restored onto 1x2.
A child that fails fails every test that reads it, with its output.

Tolerances: the compressed all-reduce against the reference to fp32
rounding (both sum exact integers), and against the exact fp32 sum under
the reference test's bounds (2e-2 one-shot, 5e-3 after 16 error-feedback
steps); the sharded forward within the reference test's 2e-2 of the
reference's unsharded forward; a 2x2 train step against the 1-device step
under ``DENSE_BUDGET["float32"]``; greedy tokens and the restore exact.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as JP

import _torch_sharding_children as kids
from _tolerance import dense_budget
from _torch_parity import one_rank_mesh

from repro.configs import ARCH_NAMES, cache_specs as jcache_specs
from repro.configs import get_config as jget
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro.models import unembed as junembed
from repro.parallel import sharding as jsh
from repro.train.optimizer import QTensor as JQTensor
from repro.train.optimizer import adamw_init as jadamw_init

from repro_torch.configs import get_config
from repro_torch.kernels import matmul_kernels, ops
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.parallel import sharding
from repro_torch.train.optimizer import QTensor

ROOT = Path(__file__).resolve().parent.parent
CHILDREN = Path(kids.__file__)
CHILD_TIMEOUT = 240      # backstop; both children take 20-40 s together
MOMENTS = ("float32", "bfloat16", "int8")
#: (batch, cache length) of the decode caches whose specs are compared.
CACHES = ((128, 32768), (1, 4096))


# ---------------------------------------------------------------------------
# The children, started when the module starts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The numpy inputs of both children, and what the reference computes
    on one device here: the Qwen3 smoke logits of its own weights."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    jcfg = jget("qwen3-1.7b", smoke=True)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    toks = rng.integers(0, jcfg.vocab_size, (kids.B, kids.S)) \
        .astype(np.int32)
    want = np.asarray(junembed(jcfg, params,
                               jforward(jcfg, params, toks)["x"]))
    flat = {"p/" + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    tmp = tmp_path_factory.mktemp("sharding")
    np.savez(tmp / "inputs.npz", x=x, tokens=toks, **flat)
    return {"dir": tmp, "x": x, "fwd": want}


@pytest.fixture(scope="module", autouse=True)
def spawned(inputs):
    """Both children, started together as the module starts; killed if a
    test leaves them running."""
    tmp = inputs["dir"]
    base = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "REPRO_TORCH_AUTOTUNE_CACHE": str(tmp / "autotune_torch.json")}
    ref_env = {**base, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port_env = {**base, "OMP_NUM_THREADS": "1"}
    inp = str(tmp / "inputs.npz")
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(CHILDREN), "reference", inp,
             str(tmp / "reference.npz")], env=ref_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen(
            [sys.executable, str(CHILDREN), "port", inp, str(tmp)],
            env=port_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    try:
        yield procs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def children(spawned, inputs):
    """(reference answers, port answers, port facts)."""
    logs = {}
    for name, proc in spawned.items():
        logs[name] = proc.communicate(timeout=CHILD_TIMEOUT)[0]
    for name, proc in spawned.items():
        assert proc.returncode == 0, f"{name} child failed:\n{logs[name]}"
    tmp = inputs["dir"]
    return (dict(np.load(tmp / "reference.npz")),
            dict(np.load(tmp / "port.npz")),
            json.loads((tmp / "port.json").read_text()))


# ---------------------------------------------------------------------------
# (a) Spec parity on the production meshes, no devices
# ---------------------------------------------------------------------------

def _abstract_mesh(multi: bool):
    sizes, names = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    try:
        return AbstractMesh(sizes, names)       # newer jax
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def meshes(request):
    """(the reference's AbstractMesh, the port's production mesh) on a
    fake process group of 256 / 512 ranks, destroyed before the test
    ends."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    multi = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        yield (_abstract_mesh(multi),
               make_production_mesh(multi_pod=multi, device="cpu"))
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str, moments: str):
    """The reference's train state of ``arch`` at full size as shapes."""
    cfg = jget(arch).replace(optimizer_state_dtype=moments)
    params = jax.eval_shape(lambda: jinit(cfg, jax.random.PRNGKey(0)))
    return cfg, jax.eval_shape(
        lambda: {"params": params, "opt": jadamw_init(params, moments)})


def _meta(tree):
    """The port's tree of meta tensors for a tree of reference shapes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return QTensor(_meta(tree.q), _meta(tree.scale), tuple(tree.shape),
                       int(tree.n))
    return torch.empty(tuple(tree.shape), device="meta")


def _ref_flat(spec_tree) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            spec_tree, is_leaf=lambda s: isinstance(s, JP))[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k)))
                for k in path]
        out["/".join(keys)] = tuple(spec)
    return out


def _port_flat(spec_tree, prefix=()) -> dict:
    if isinstance(spec_tree, dict):
        out = {}
        for k, v in spec_tree.items():
            out.update(_port_flat(v, prefix + (k,)))
        return out
    if isinstance(spec_tree, QTensor):
        return {"/".join(prefix + ("0",)): tuple(spec_tree.q),
                "/".join(prefix + ("1",)): tuple(spec_tree.scale)}
    return {"/".join(prefix): tuple(spec_tree)}


def _same(want: dict, got: dict, what: str):
    assert set(got) == set(want), what
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    assert not bad, f"{what}: {dict(list(bad.items())[:5])}"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_the_reference(arch, meshes):
    """param_specs in both modes, state_specs for every moment dtype the
    optimizer stores, cache_partition_specs and batch_specs, entry by
    entry."""
    jmesh, mesh = meshes
    cfg = get_config(arch)
    for mode in ("train", "decode"):
        jcfg, jstate = _ref_shapes(arch, "float32")
        state = _meta(jstate)
        _same(_ref_flat(jsh.param_specs(jstate["params"], jcfg, jmesh,
                                        mode)),
              _port_flat(sharding.param_specs(state["params"], cfg, mesh,
                                              mode)),
              f"param_specs {mode}")
        for moments in MOMENTS:
            jcfg, jstate = _ref_shapes(arch, moments)
            pcfg = cfg.replace(optimizer_state_dtype=moments)
            _same(_ref_flat(jsh.state_specs(jstate, jcfg, jmesh, mode)),
                  _port_flat(sharding.state_specs(_meta(jstate), pcfg, mesh,
                                                  mode)),
                  f"state_specs {mode} {moments}")
    for batch, length in CACHES:
        jcache = jcache_specs(jget(arch), batch, length)
        _same(_ref_flat(jsh.cache_partition_specs(jcache, jget(arch),
                                                  jmesh)),
              _port_flat(sharding.cache_partition_specs(_meta(jcache), cfg,
                                                        mesh)),
              f"cache_partition_specs {batch}x{length}")
    _same(_ref_flat(jsh.batch_specs(jmesh, "lm")),
          _port_flat(sharding.batch_specs(mesh, "lm")), "batch_specs")


def test_named_places_specs_on_the_mesh(meshes):
    """``named`` turns a spec into DTensor placements: ``Shard(d)`` on each
    mesh dim that entry ``d`` names (an axis tuple on each of its dims,
    major first), ``Replicate`` elsewhere; a mesh dim named twice shards
    the first dim that names it."""
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = meshes
    multi = "pod" in mesh.mesh_dim_names
    tok = sharding.named(mesh, sharding.batch_specs(mesh, "lm"))["tokens"]
    want = ((Shard(0), Shard(0), Replicate()) if multi
            else (Shard(0), Replicate()))
    assert tok.placements == want
    assert dp_axes(mesh) == (("pod", "data") if multi else ("data",))
    emb = sharding.NamedSharding(mesh, sharding.P("model", "data"))
    assert emb.placements[-2:] == (Shard(1), Shard(0))
    dup = sharding.NamedSharding(mesh, sharding.P("data", "data", "model"))
    assert dup.placements[-2:] == (Shard(0), Shard(2))


def test_production_mesh_needs_its_world_size():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device="cpu")
    with one_rank_mesh():
        with pytest.raises(ValueError, match="512 ranks, got 1"):
            make_production_mesh(multi_pod=True, device="cpu")


def test_a_launch_handed_a_dtensor_raises():
    """K1's ctypes launch takes one pointer per operand: a DTensor raises
    there and in ``ops.matmul``, while ``ops.dense_matmul`` runs the op on
    its local shards (one product on a 1x1 mesh)."""
    from torch.distributed.tensor import DTensor, Replicate
    with one_rank_mesh() as mesh:
        a = DTensor.from_local(torch.ones(4, 8), mesh,
                               [Replicate(), Replicate()])
        b = DTensor.from_local(torch.ones(8, 3), mesh,
                               [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ops.matmul(a, b)
        with pytest.raises(TypeError, match="DTensor"):
            matmul_kernels.matmul_cuda(a, b, block_m=16, block_n=16,
                                       block_k=16)
        matmul_kernels.reset_launches()
        y = ops.dense_matmul(a, b)
        assert matmul_kernels.launch_counts()["plain_matmul"] == 1
        assert isinstance(y, DTensor)
        torch.testing.assert_close(y.to_local(), torch.full((4, 3), 8.0))


# ---------------------------------------------------------------------------
# (b) compressed_psum / ef_compress against the reference
# ---------------------------------------------------------------------------

def test_compressed_psum_matches_the_reference(children, inputs):
    ref, port, _ = children
    np.testing.assert_allclose(port["cp"], ref["cp"], rtol=1e-6, atol=1e-6)
    want = inputs["x"].sum(axis=0)
    rel = np.abs(port["cp"][0] - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel


def test_ef_compress_matches_the_reference(children):
    """Two error-feedback steps: every rank's sum and its residual, which
    is measured against the shared-scale decode."""
    ref, port, _ = children
    for k in ("r1", "e1", "r2", "e2"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_error_feedback_converges(children, inputs):
    _, port, _ = children
    truth = 16 * inputs["x"].sum(axis=0)
    rel = np.abs(port["ef16"][0] - truth).max() / np.abs(truth).max()
    assert rel < 5e-3, rel


# ---------------------------------------------------------------------------
# (b) The LM on a 2x2 mesh
# ---------------------------------------------------------------------------

def test_sharded_forward_matches_the_reference(children, inputs):
    """DP=2 x TP=2 with the train specs against the reference's unsharded
    forward of the same weights (the reference test's bound)."""
    _, port, _ = children
    err = np.abs(port["fwd"] - inputs["fwd"]).max()
    assert err < 2e-2, err


@pytest.mark.parametrize("arch", kids.CONFIGS)
def test_train_step_on_2x2_matches_one_device(children, arch):
    """One step (2 microbatches) through ``launch.train.build(mesh=...)``
    from the same state and batch as ``make_train_step`` on one device."""
    facts = children[2][arch]
    rtol, atol = dense_budget("float32")
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(facts["mesh"][k], facts["one"][k],
                                   rtol=rtol, atol=atol, err_msg=k)
    assert facts["param_diff"] <= atol


@pytest.mark.parametrize("arch", kids.CONFIGS)
def test_each_rank_makes_the_one_device_dense_products(children, arch):
    """Every projection's forward, recomputation, dx and dw is one product
    on each rank's local shards: each rank counts what one device does."""
    for key in (arch, f"generate_{arch}"):
        facts = children[2][key]
        assert facts["products_mesh"] == [facts["products_one"]] * 4, key


#: The collectives of one qwen3 smoke train step (2 microbatches) on the
#: 2x2 mesh, by kind (CommDebugMode): the FSDP all-gathers of the weights
#: and reduce-scatters of their gradients, the TP all-reduces, the batch's
#: one gather, the loss and norm reductions.
QWEN3_STEP_COLLECTIVES = {
    "c10d_functional.all_gather_into_tensor": 160,
    "c10d_functional.all_reduce": 52,
    "c10d_functional.reduce_scatter_tensor": 28,
}


def test_the_collectives_of_a_qwen3_step_are_pinned(children):
    got = children[2]["qwen3-1.7b"]["collectives"]
    assert got == QWEN3_STEP_COLLECTIVES, got


@pytest.mark.parametrize("arch", kids.CONFIGS)
def test_generate_on_a_2x2_decode_mesh_gives_the_unsharded_tokens(
        children, arch):
    facts = children[2][f"generate_{arch}"]
    assert facts["got"] == facts["want"]


def test_int8_moments_change_layout_without_a_whole_tensor(children):
    """A tensor under several placements taken to the int8 moments' row
    layout (``parallel.sharding.to_flat_rows``, one all-to-all) holds
    exactly the rows of the tensor flattened, comes back bit for bit, and
    quantizes and decodes on the mesh exactly as on one device."""
    assert children[2]["flat_rows_mismatched"] == []


def test_int8_train_step_on_2x2_matches_one_device(children):
    """Qwen3 smoke with int8 moments placed by ``state_specs``' int8
    branch (rows over "data"): one 2x2 step against one device. The
    parameters as for fp32 moments; the stored codes at most one step
    apart (a value at a rounding edge), the block scales within the fp32
    budget."""
    facts = children[2][kids.INT8]
    rtol, atol = dense_budget("float32")
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(facts["mesh"][k], facts["one"][k],
                                   rtol=rtol, atol=atol, err_msg=k)
    assert facts["param_diff"] <= atol
    assert facts["q_placements"] == ["Shard(0)", "Replicate"]
    assert facts["q_max_diff"] <= 1
    assert facts["scale_max_rel"] <= rtol
    assert facts["products_mesh"] == [facts["products_one"]] * 4


def test_a_save_on_2x2_restores_onto_1x2_bit_for_bit(children):
    facts = children[2]["restore"]
    assert facts["step"] == 1
    assert facts["mismatched"] == []
    assert facts["leaves"] > 20
    # qwen3 smoke's vocab-parallel embedding on (data=1, model=2)
    assert facts["embed_placements"] == ["Shard(1)", "Shard(0)"]
    assert facts["embed_local_shape"] == [128, 64]


def test_a_shard_ctx_axis_that_does_not_divide_replicates(children):
    facts = children[2]
    assert facts["odd_placements"] == ["Replicate", "Shard(1)"]
    assert facts["odd_local_shape"] == [3, 2]


def test_restore_with_shardings_places_each_leaf(tmp_path):
    """``load_pytree(..., shardings=)`` places each restored leaf on its
    sharding (here a 1x1 mesh in this process); ``shardings=None`` (and a
    leaf whose sharding is None) restores as before."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.checkpoint.checkpointer import (Checkpointer,
                                                     load_pytree,
                                                     save_pytree)
    tree = {"w": torch.arange(12.0).reshape(4, 3), "b": torch.ones(3),
            "step": torch.tensor(5, dtype=torch.int32)}
    save_pytree(tree, tmp_path / "ck")
    Checkpointer(tmp_path / "root").save(3, tree)
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in tree.items()}
    plain = load_pytree(template, tmp_path / "ck")
    assert all(type(v) is torch.Tensor and torch.equal(v, tree[k])
               for k, v in plain.items())
    with one_rank_mesh() as mesh:
        sh = {"w": sharding.NamedSharding(mesh, sharding.P("data", "model")),
              "b": None,
              "step": sharding.NamedSharding(mesh, sharding.P())}
        got = load_pytree(template, tmp_path / "ck", shardings=sh)
        step, again = Checkpointer(tmp_path / "root").restore(
            None, template, shardings=sh)
        for out in (got, again):
            assert isinstance(out["w"], DTensor)
            assert out["w"].placements == (Shard(0), Shard(1))
            assert out["step"].placements == (Replicate(), Replicate())
            assert type(out["b"]) is torch.Tensor
            assert all(torch.equal(sharding_full(v), tree[k])
                       for k, v in out.items())
        assert step == 3


def sharding_full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


# ---------------------------------------------------------------------------
# (c) Full width on the production meshes: heads that tp does not divide
# ---------------------------------------------------------------------------

#: Attention configs whose kv heads (or heads) the 16-wide "model" axis
#: does not divide: the k/v projection's columns come out sharded over
#: tp, and splitting them into heads must gather them first.
UNEVEN_HEADS = ("qwen3-1.7b", "mixtral-8x7b", "whisper-base",
                "llava-next-mistral-7b", "starcoder2-15b")


@pytest.fixture
def head_splits(monkeypatch):
    """Every ``layers.split_heads`` of a step: (global shape, local
    shape) of its output."""
    from repro_torch.models import layers
    seen, split = [], layers.split_heads

    def spy(y, n, dh):
        out = split(y, n, dh)
        seen.append((tuple(out.shape), tuple(out.to_local().shape)))
        return out
    monkeypatch.setattr(layers, "split_heads", spy)
    return seen


def _whole_heads(seen):
    """Every split's local shard holds whole heads: all of a head's
    ``d_head`` columns, and a share of the heads that divides them."""
    assert seen
    for full, local in seen:
        assert local[-1] == full[-1] and full[-2] % local[-2] == 0, \
            (full, local)


@pytest.mark.parametrize("arch", UNEVEN_HEADS)
def test_a_full_width_train_step_on_the_16x16_mesh(arch, head_splits):
    """One train step at full width, cut to one layer-pattern period, on
    meta tensors on the fake 256-rank mesh, batch = dp and one
    microbatch: it runs, and q / k / v are split into whole heads."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    shape = ShapeSpec("one_row_a_rank", 128 + cfg.n_vision_tokens, 16,
                      "train")
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device="cpu")
        fn, args, cfg, _ = dryrun.build_cell(arch, shape, mesh, depth=1)
        assert cfg.grad_accum == 1
        state, metrics = fn(*args)
    assert set(metrics) >= {"loss", "ce", "grad_norm"}
    _whole_heads(head_splits)


def test_a_full_width_decode_step_on_the_2x16x16_mesh(head_splits):
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    shape = ShapeSpec("decode_1k", 1024, 32, "decode")
    with dryrun.fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device="cpu")
        fn, args, _, _ = dryrun.build_cell("qwen3-1.7b", shape, mesh,
                                           depth=1)
        logits, cache = fn(*args)
    assert tuple(logits.shape) == (32, 1, get_config("qwen3-1.7b")
                                   .vocab_size)
    assert tuple(cache["k"].shape) == (1, 32, 1024, 8, 128)
    _whole_heads(head_splits)
