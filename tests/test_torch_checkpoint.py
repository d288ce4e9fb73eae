"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``).

The reference's tests/test_checkpoint.py on CPU tensors: round trip,
corruption detected, retention, kill mid-save, async save, restore casts
dtype, mesh-independent layout. Then the crossing between the packages,
which share the files: a checkpoint the reference wrote restores here for
every leaf dtype (fp32, bf16, int32, int8 moments in ``QTensor`` form), and
an fp32 / integer one written here restores in the reference. A bf16 leaf
written here is its uint16 bits under a ``"bfloat16"`` manifest entry,
which the reference's ``astype`` does not read as bf16 — that direction is
not claimed (ROADMAP's deliberate differences).
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.checkpointer import (load_pytree as jload,
                                           save_pytree as jsave)
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import (Checkpointer, load_pytree,
                                                 save_pytree)
from repro_torch.train.optimizer import QTensor, adamw_init


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((32, 16), generator=g),
                   "b": torch.zeros((16,))},
        "opt": {"m": {"w": torch.ones((32, 16)) * 0.5,
                      "b": torch.zeros((16,))},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, QTensor):
        return [tree.q, tree.scale]
    return [tree]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "ck")
    template = {"params": {k: torch.empty_like(v, device="meta")
                           for k, v in tree["params"].items()},
                "opt": tree["opt"]}
    got = load_pytree(template, tmp_path / "ck")
    _assert_same(tree, got)
    assert got["params"]["w"].device.type == "cpu"


def test_corruption_detected(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "ck")
    shard = next((tmp_path / "ck").glob("shard_*.npz"))
    data = shard.read_bytes()
    shard.write_bytes(data[:-8] + b"xxxxxxxx")
    with pytest.raises(IOError, match="corrupt"):
        load_pytree(tree, tmp_path / "ck")


def test_missing_key_refused(tmp_path):
    save_pytree({"a": torch.ones(3)}, tmp_path / "ck")
    with pytest.raises(KeyError, match="missing"):
        load_pytree({"a": torch.ones(3), "b": torch.ones(2)},
                    tmp_path / "ck")


def test_checkpointer_latest_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in (10, 20, 30):
        ck.save(step, _tree(step))
    assert ck.latest_step() == 30
    assert ck.steps() == [20, 30]        # keep=2 pruned step_10


def test_kill_mid_save_never_corrupts_previous(tmp_path):
    """A stale tmp dir (crashed save) must not break discovery or restore,
    and the previous good checkpoint survives."""
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree(1))
    fake = tmp_path / "step_2.tmp-deadbeef"
    fake.mkdir()
    (fake / "shard_00000.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 1
    step, got = ck.restore(None, _tree(9))
    assert step == 1
    _assert_same(got, _tree(1))
    ck2 = Checkpointer(tmp_path, keep=3)
    assert not fake.exists()
    ck2.save(2, _tree(2))
    assert ck2.latest_step() == 2


def test_async_save_snapshots_before_returning(tmp_path):
    """``blocking=False`` returns before the write, with the tree already
    on the host: an in-place update right after the call (what the train
    step does) does not reach the checkpoint."""
    ck = Checkpointer(tmp_path)
    tree = _tree(5)
    want = _tree(5)
    gate = threading.Event()
    real = ck._write
    ck._write = lambda *a: (gate.wait(10), real(*a))
    ck.save(5, tree, blocking=False)
    tree["params"]["w"].add_(1.0)
    gate.set()
    ck.wait()
    assert ck.latest_step() == 5
    _, got = ck.restore(5, _tree(0))
    _assert_same(got, want)


def test_restore_casts_dtype(tmp_path):
    """A restore may change a leaf's dtype (fp32 masters -> bf16)."""
    save_pytree({"w": torch.arange(8, dtype=torch.float32)}, tmp_path / "ck")
    got = load_pytree({"w": torch.empty(8, dtype=torch.bfloat16)},
                      tmp_path / "ck")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(8.0))


def test_mesh_independent_layout(tmp_path):
    save_pytree(_tree(), tmp_path / "ck")
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert "mesh" not in json.dumps(manifest).lower()
    for key in manifest["keys"]:
        assert "/" in key   # path-addressed, not rank-addressed


def test_bf16_and_qtensor_round_trip(tmp_path):
    state = {"w": torch.randn(5, 7).bfloat16(),
             "opt": adamw_init({"w": torch.randn(300)}, "int8")}
    state["opt"]["m"]["w"] = QTensor.quantize(torch.randn(300))
    save_pytree(state, tmp_path / "ck")
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["keys"]["w"]["dtype"] == "bfloat16"
    assert set(manifest["keys"]) >= {"opt/m/w/0", "opt/m/w/1", "opt/step"}
    template = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                "opt": adamw_init({"w": torch.zeros(300)}, "int8")}
    got = load_pytree(template, tmp_path / "ck")
    _assert_same(got, state)
    assert got["opt"]["m"]["w"].shape == (300,)


def _jtree():
    k = jax.random.PRNGKey(3)
    return {"params": {"w": jax.random.normal(k, (32, 16)),
                       "h": jax.random.normal(k, (4, 6)).astype(
                           jnp.bfloat16)},
            "opt": {**jadamw_init({"w": jnp.ones((300,))}, "int8"),
                    "count": jnp.int32(7)}}


def test_a_reference_checkpoint_restores_here(tmp_path):
    jt = _jtree()
    jsave(jt, tmp_path / "ck")
    opt = jt["opt"]
    template = {"params": {"w": torch.zeros(32, 16),
                           "h": torch.zeros(4, 6, dtype=torch.bfloat16)},
                "opt": {**adamw_init({"w": torch.zeros(300)}, "int8"),
                        "count": torch.tensor(0, dtype=torch.int32)}}
    got = load_pytree(template, tmp_path / "ck")
    want = convert.train_state_from_reference(
        {"params": jt["params"], "opt": opt}, device="cpu")
    _assert_same(got["params"], want["params"])
    _assert_same(got["opt"]["m"], want["opt"]["m"])
    _assert_same(got["opt"]["v"], want["opt"]["v"])
    assert int(got["opt"]["count"]) == 7
    assert got["params"]["h"].dtype == torch.bfloat16


def test_an_fp32_checkpoint_written_here_restores_in_the_reference(
        tmp_path):
    state = {"params": {"w": torch.randn(32, 16), "b": torch.zeros(16)},
             "opt": adamw_init({"w": torch.randn(300)}, "int8")}
    state["opt"]["m"]["w"] = QTensor.quantize(torch.randn(300))
    state["opt"]["step"].fill_(4)
    save_pytree(state, tmp_path / "ck")
    template = {"params": {"w": jax.ShapeDtypeStruct((32, 16), jnp.float32),
                           "b": jax.ShapeDtypeStruct((16,), jnp.float32)},
                "opt": jadamw_init({"w": jnp.zeros((300,))}, "int8")}
    got = jload(template, tmp_path / "ck")
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  state["params"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(got["opt"]["m"]["w"].q),
                                  state["opt"]["m"]["w"].q.numpy())
    np.testing.assert_array_equal(np.asarray(got["opt"]["m"]["w"].scale),
                                  state["opt"]["m"]["w"].scale.numpy())
    assert int(got["opt"]["step"]) == 4
