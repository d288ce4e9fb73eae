"""``repro_torch.core.distributed`` vs ``repro.core.distributed`` and numpy.

The reference's tests/test_distributed.py (the sharded-chain half) on the
port. Multi-rank meshes run in child processes
(``tests/_torch_distributed_children.py``), as the reference forces a
4-device CPU in a child: ONE JAX child computes the reference's answers on
1x1, 1x4 and 2x2 meshes, and ONE ``torch.multiprocessing`` child spawns a
4-rank ``gloo`` group that runs the port on its 2x2 and 1x4 meshes. Both
start together, once for the module, from the same numpy inputs (made from
seeds). The 1x1 cases run in this process, on a one-rank group a fixture
creates and destroys.

Tolerances: the port against the reference in f32 and bf16 under
``DENSE_BUDGET`` (``tests/_tolerance.py``, ``mults`` the chain's multiply
count); f64 against numpy float64 at a peak-relative 1e-12, which the
reference does not meet (see ``test_f64_chain_accumulates_in_f64``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _torch_distributed_children as kids
from _tolerance import assert_within_budget
from _torch_parity import matpow_mults, one_rank_mesh, randn, stochastic

from repro_torch.core import (ShardedMatmulChain, expm, expm_sharded,
                              matmul_2d_gather, matmul_cannon,
                              matpow_sharded, sharded_matmul, steady_state)
from repro_torch.core.distributed import _pick_algorithm
from repro_torch.kernels import ops
from repro_torch.serve import MatFnEngine

ROOT = Path(__file__).resolve().parent.parent
CHILDREN = Path(kids.__file__)
CHILD_TIMEOUT = 300      # backstop; both children take 10-30 s together
F64_RTOL = 1e-12


def _mixing(n, seed) -> np.ndarray:
    """A dense row-stochastic matrix (|gaussian| + 0.05, rows normalised):
    it mixes in a few squarings, far above float32's residual floor. (A
    slow mixer such as ``stochastic``'s cycle bottoms out near 1e-6 in
    float32, where the summation order decides the squaring at which the
    residual crosses ``tol``.)"""
    m = np.abs(randn((n, n), seed)) + 0.05
    return (m / m.sum(axis=1, keepdims=True)).astype(np.float32)


def _inputs() -> dict:
    p45 = stochastic(45, 5).astype(np.float64)
    return {"a64": randn((64, 64), 0, 0.2), "b64": randn((64, 64), 1, 0.2),
            "a67": stochastic(kids.N, 2), "s67": randn((67, 67), 3, 0.3),
            "p45": p45 / p45.sum(axis=1, keepdims=True),
            "e64": randn((64, 64), 4, 0.5 / 8), "p64": _mixing(64, 6)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def children(tmp_path_factory, inputs):
    """(reference answers, port answers, port facts): both children run at
    once; a failing child fails every test that reads it, with its
    output."""
    tmp = tmp_path_factory.mktemp("distributed")
    inp = tmp / "inputs.npz"
    np.savez(inp, **inputs)
    base = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "REPRO_TORCH_AUTOTUNE_CACHE": str(tmp / "autotune_torch.json")}
    ref_env = {**base, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port_env = {**base, "OMP_NUM_THREADS": "1"}
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, str(CHILDREN), "reference", str(inp),
             str(tmp / "reference.npz")], env=ref_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen(
            [sys.executable, str(CHILDREN), "port", str(inp), str(tmp)],
            env=port_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)}
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=CHILD_TIMEOUT)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name} child failed:\n{logs[name]}"
    return (dict(np.load(tmp / "reference.npz")),
            dict(np.load(tmp / "port.npz")),
            json.loads((tmp / "port.json").read_text()))


@pytest.fixture
def mesh():
    """The in-process 1x1 mesh, on a group this fixture creates and
    destroys."""
    with one_rank_mesh() as m:
        yield m


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float64)


def _peak_rel(got, want) -> float:
    got, want = _f64(got), _f64(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float64": torch.float64}
CASES = [pytest.param(shape, alg, id=f"{shape[0]}x{shape[1]}-{alg}")
         for shape, alg in kids.MESH_ALGS]


def _port_power(shape, alg, dtype, p, children, inputs, request):
    """The port's A^p for one case: in this process on 1x1 (its own
    one-rank group), else from the 4-rank child."""
    if shape == (1, 1):
        m = request.getfixturevalue("mesh")
        a = torch.from_numpy(inputs["a67"]).to(TORCH[dtype])
        got = matpow_sharded(a, p, m, algorithm=alg)
        assert got.shape == (kids.N, kids.N) and got.dtype == TORCH[dtype]
        return got.full_tensor()
    return children[1][kids.key(shape, alg, dtype, p)]


# ---------------------------------------------------------------------------
# The two schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gather", "cannon"])
def test_cannon_and_gather_match_reference(children, inputs, name):
    """2x2 mesh, 64²: the port's schedule against the reference's and
    against float64 (the reference's own 1e-4)."""
    ref, port, _ = children
    got = port[f"{name}_64"]
    assert_within_budget(got, ref[f"{name}_64"], jnp.float32, n=64)
    want = _f64(inputs["a64"]) @ _f64(inputs["b64"])
    assert np.abs(got - want).max() < 1e-4


def test_dtensor_operands(children, inputs):
    """2x2: a replicated DTensor is redistributed to the chain's placement
    before Cannon's blocks move, and ``matpow_sharded`` takes a DTensor
    (gathered, then padded and placed as a plain tensor would be)."""
    _, port, _ = children
    a, b = _f64(inputs["a64"]), _f64(inputs["b64"])
    assert np.abs(port["cannon_replicated"] - a @ b).max() < 1e-4
    assert _peak_rel(port["pow_of_dtensor"],
                     np.linalg.matrix_power(a @ b, 3)) < 1e-4


@pytest.mark.parametrize("fn", [matmul_2d_gather, matmul_cannon,
                                sharded_matmul])
def test_schedules_on_one_rank(mesh, inputs, fn):
    a = torch.from_numpy(inputs["a64"])
    b = torch.from_numpy(inputs["b64"])
    got = fn(a, b, mesh)
    assert tuple(got.placements) == tuple(
        ShardedMatmulChain(64, torch.float32, mesh).layout.placements)
    want = _f64(inputs["a64"]) @ _f64(inputs["b64"])
    assert np.abs(_f64(got.full_tensor()) - want).max() < 1e-4


def test_pick_algorithm():
    assert _pick_algorithm("auto", 2, 2) == "cannon"
    assert _pick_algorithm("auto", 1, 1) == "gather"
    assert _pick_algorithm("auto", 1, 4) == "gather"
    assert _pick_algorithm("cannon", 1, 1) == "cannon"
    with pytest.raises(ValueError, match="unknown algorithm"):
        _pick_algorithm("summa", 2, 2)


def test_cannon_needs_a_square_mesh(children):
    assert children[2]["cannon_1x4"].startswith(
        "Cannon needs a square mesh, got 1x4")


def test_uneven_operands_are_refused(children, mesh):
    """The bare schedules need even shards (67 over 2 ranks is not); the
    chain pads instead, and takes one (n, n) matrix."""
    assert "does not shard evenly over a 2x2 mesh" in children[2]["uneven"]
    chain = ShardedMatmulChain(67, torch.float32, mesh)
    assert chain.padded_n == 128                 # K1's 64-wide tile
    with pytest.raises(ValueError, match="one \\(67, 67\\) matrix"):
        chain.pad(torch.zeros(3, 67, 67))


# ---------------------------------------------------------------------------
# matpow_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", kids.POWERS)
@pytest.mark.parametrize("dtype", kids.DTYPES)
@pytest.mark.parametrize("shape,alg", CASES)
def test_matpow_sharded_matches_reference(children, inputs, request, shape,
                                          alg, dtype, p):
    """n = 67 (no mesh divides it: the chain pads once) on 1x1, 1x4 and
    2x2, each schedule forced where it applies, against the reference's
    ``matpow_sharded`` on the same mesh and the same bits."""
    got = _port_power(shape, alg, dtype, p, children, inputs, request)
    want = children[0][kids.key(shape, alg, dtype, p)]
    if p == 0:
        np.testing.assert_array_equal(_f64(got), np.eye(kids.N))
    assert_within_budget(_f64(got), want, getattr(jnp, dtype), n=kids.N,
                         mults=matpow_mults(p))


@pytest.mark.parametrize("p", kids.POWERS)
@pytest.mark.parametrize("shape,alg", CASES)
def test_f64_chain_accumulates_in_f64(children, inputs, request, shape, alg,
                                      p):
    """A float64 chain is float64-accurate: within a peak-relative 1e-12 of
    ``np.linalg.matrix_power``. The reference computes its local products
    with ``preferred_element_type=jnp.float32`` and a float32 Cannon
    accumulator (``src/repro/core/distributed.py:70,129``): A^13 at
    n = 64 on a 2x2 mesh under ``jax_enable_x64`` comes out 1.2e-7
    (cannon) and 8.0e-8 (gather) from the float64 power. The port
    accumulates f64 in f64, as the reference's own oracle does."""
    got = _port_power(shape, alg, "float64", p, children, inputs, request)
    want = np.linalg.matrix_power(_f64(inputs["a67"]), p)
    assert _peak_rel(got, want) <= F64_RTOL


def test_pads_exactly_once(children, mesh, inputs, monkeypatch):
    """ONE pad (an ``ops.pad_to_blocks`` call that pads) per chain at
    n = 67, none at a divisible size (64), however many squarings and
    combines run: the shards are padded to K1's tile, so no local product
    pads again (2x2 in the child, 1x1 here)."""
    facts = children[2]
    assert (facts["pads_67"], facts["pads_64"]) == (1, 0)
    calls = []
    real = ops.pad_to_blocks

    def counting(x, bm, bn):
        # Every ops.matmul asks; a call that pads returns a new tensor.
        out = real(x, bm, bn)
        if out is not x:
            calls.append(tuple(x.shape))
        return out

    monkeypatch.setattr(ops, "pad_to_blocks", counting)
    matpow_sharded(torch.from_numpy(inputs["a67"]), 96, mesh)
    assert calls == [(67, 67)]
    calls.clear()
    matpow_sharded(torch.from_numpy(inputs["a64"]), 96, mesh)
    assert calls == []


def test_square_consumes_its_argument_not_the_callers(children, mesh,
                                                      inputs):
    """Donation, the PyTorch form: the chain ping-pongs between two local
    blocks, so the squaring after next writes into the consumed operand's
    block; ``pad`` never hands the caller's tensor in, and a whole
    ``matpow_sharded`` leaves it as it was."""
    facts = children[2]
    assert facts["consumed_gather"] and facts["consumed_cannon"]
    assert facts["caller_kept"]
    a = torch.from_numpy(inputs["a64"])
    want = np.linalg.matrix_power(_f64(a), 4)
    for alg in ("gather", "cannon"):
        got = _f64(children[1][f"square2_{alg}"])
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
        chain = ShardedMatmulChain(64, torch.float32, mesh, algorithm=alg)
        keep = a.clone()
        x = chain.pad(a)
        assert x.to_local().data_ptr() != a.data_ptr()
        y = chain.square(x)
        z = chain.square(y)
        assert z.to_local().data_ptr() == x.to_local().data_ptr()
        assert torch.equal(a, keep)
        assert np.abs(_f64(chain.unpad(z).full_tensor()) - want).max() \
            / np.abs(want).max() < 1e-4
    kept = ShardedMatmulChain(64, torch.float32, mesh, donate=False)
    x = kept.pad(a)
    kept.square(kept.square(x))
    assert torch.equal(x.to_local(), a)


@pytest.mark.parametrize("mult", [1, 16])
def test_unpad_uneven_shards(children, inputs, mult):
    """2x2, n = 67: with ``shard_multiple=1`` the padded shards (34) are
    ``Shard``'s own layout of 67 and are sliced in place; with 16 they are
    48 and the matrix is gathered and sliced. Either way a DTensor of
    global shape (67, 67) in ``torch.chunk``'s layout, holding A @ A."""
    padded, shape, local = children[2][f"unpad_{mult}"]
    assert padded == (68 if mult == 1 else 96)
    assert shape == [67, 67] and local[0] in (34, 33) and local[1] in (34, 33)
    a = _f64(inputs["a67"])
    assert _peak_rel(children[1][f"unpad_{mult}"], a @ a) < 1e-5


def test_bool_power_raises(mesh, inputs):
    a = torch.from_numpy(inputs["a67"])
    with pytest.raises(TypeError, match="bool"):
        matpow_sharded(a, True, mesh)
    with pytest.raises(ValueError, match="int n >= 0"):
        matpow_sharded(a, -1, mesh)
    with pytest.raises(ValueError, match="int n >= 0"):
        matpow_sharded(a, 2.0, mesh)


def test_a_tensor_on_another_device_is_refused(mesh, inputs):
    a = torch.empty((67, 67), device="meta")
    with pytest.raises(ValueError, match="cannot enter a mesh"):
        matpow_sharded(a, 7, mesh)
    with pytest.raises(ValueError, match="cannot enter a mesh"):
        expm_sharded(a, mesh)


def test_mesh_must_name_its_axes(mesh):
    with pytest.raises(ValueError, match="must name row_axis"):
        ShardedMatmulChain(8, torch.float32, mesh, row_axis="rows")


# ---------------------------------------------------------------------------
# expm_sharded and the steady state on the chain
# ---------------------------------------------------------------------------

def test_expm_sharded_matches_expm(children, mesh, inputs):
    """n = 67 f32 on 2x2 (child) and 1x1 (here) against the port's
    single-device ``expm``."""
    port = children[1]
    assert _peak_rel(port["expm_67"], port["expm_67_want"]) < 1e-4
    s = torch.from_numpy(inputs["s67"])
    got = expm_sharded(s, mesh)
    assert got.dtype == torch.float32 and got.shape == (67, 67)
    assert _peak_rel(got.full_tensor(), expm(s)) < 1e-4


def test_expm_sharded_mask_no_nan_near_overflow(children, mesh):
    """e^{60 I}: every squaring lands within one step of fp32 overflow; the
    ``torch.where`` mask keeps it finite and exact (2x2 and 1x1)."""
    want = np.full(64, np.exp(np.float32(60.0)))
    for got in (children[1]["expm_60I"],
                expm_sharded(60.0 * torch.eye(64), mesh).full_tensor()):
        got = _f64(got)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(np.diag(got), want, rtol=1e-5)


@pytest.mark.parametrize("mult", [1, 16])
def test_steady_state_on_the_sharded_chain(children, inputs, mult):
    """``steady_state(chain=ShardedMatmulChain(...))`` on 2x2: the residual
    is a collective every rank reads, so every rank stops at the same
    squaring, with the single-device answer (f64, padded rows never
    leaking into the residual or pi)."""
    p = torch.from_numpy(inputs["p45"])
    want = steady_state(p)
    assert children[2][f"steady_{mult}"] == int(want.squarings)
    assert _peak_rel(children[1][f"steady_pi_{mult}"], want.pi) < F64_RTOL
    assert _peak_rel(children[1][f"steady_m_{mult}"], want.matrix) \
        < F64_RTOL


# ---------------------------------------------------------------------------
# The engine's sharded route on a 2x2 mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["matpow", "expm", "pi", "m"])
def test_engine_flush_on_a_2x2_mesh(children, what):
    """Flush mode, thresholds (8, 48): one 64² matpow, expm and markov
    steady state each take the ``sharded`` route (an 8² matpow the
    ``torch`` route), every answer within ``error_budget`` of the
    per-matrix call."""
    _, port, facts = children
    assert facts["eng_routes"]["sharded"] == 3
    assert facts["eng_routes"]["torch"] == 1
    assert facts["eng_squarings"][0] == facts["eng_squarings"][1]
    assert_within_budget(port[f"eng_{what}"], port[f"eng_{what}_want"],
                         jnp.float32, n=64, mults=8)


def test_daemon_on_a_multi_rank_mesh_raises(children, mesh, inputs):
    facts = children[2]
    assert "daemon mode needs every rank" in facts["daemon"]
    assert not facts["daemon_running"]
    # a one-rank mesh serves in daemon mode
    with MatFnEngine(device="cpu", mesh=mesh, thresholds=(8, 48)) as eng:
        fut = eng.submit("matpow", torch.from_numpy(inputs["e64"]), power=7)
        eng.kick()
        got = fut.result(timeout=30)
    assert eng.stats()["routes"]["sharded"] == 1
    want = np.linalg.matrix_power(_f64(inputs["e64"]), 7)
    assert _peak_rel(got, want) < 2e-3


def test_engine_mesh_on_another_device_raises(mesh):
    class CudaMesh:
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh is over 'cuda'"):
        MatFnEngine(device="cpu", mesh=CudaMesh())
