"""``models/layers.py`` against the reference's, on the CPU.

Each primitive and block takes the same numpy-made inputs and the
reference's weights (carried by ``convert.params_from_reference``); the
port runs every ``dense`` through ``ops.dense_matmul``'s plain version.
Tolerance: ``DENSE_BUDGET`` of the compute dtype as ``(rtol, atol)``
(float32 (2e-3, 1e-5); bfloat16 (0.15, 0.05)). The attention scores and
P·V products are fp32 ``torch`` products with ``exact_matmul_settings()``
in force.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro_torch import convert, exact_matmul_settings
from repro_torch.configs import get_config
from repro_torch.kernels import matmul_kernels as K
from repro_torch.models import layers as L

from _torch_lm import assert_lm_close, f64
from _torch_parity import pair

exact_matmul_settings()


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,bias", [("rmsnorm", False),
                                       ("layernorm", True)])
def test_norm(kind, bias, dtype):
    jx, tx = pair(_normal((2, 5, 24), 0), dtype)
    jw, tw = pair(1 + _normal((24,), 1, 0.1), "float32")
    jb, tb = pair(_normal((24,), 2, 0.1), "float32") if bias else (None,
                                                                    None)
    want = JL.norm(jx, jw, kind=kind, eps=1e-5, bias=jb)
    got = L.norm(tx, tw, kind=kind, eps=1e-5, bias=tb)
    assert got.dtype == tx.dtype
    assert_lm_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    jx, tx = pair(_normal((2, 7, 3, 16), 3), dtype)
    pos = np.arange(7, dtype=np.int32)[None] + np.array([[0], [40]],
                                                       np.int32)
    want = JL.rope(jx, jnp.asarray(pos), theta=1e6)
    got = L.rope(tx, torch.from_numpy(pos), theta=1e6)
    assert got.dtype == tx.dtype
    assert_lm_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,n,bias", [((3, 1, 64), 96, True),
                                          ((2, 9, 48), 70, False)])
def test_dense_runs_k1s_plain_version(shape, n, bias, dtype):
    jx, tx = pair(_normal(shape, 4), dtype)
    jw, tw = pair(_normal((shape[-1], n), 5, shape[-1] ** -0.5), "float32")
    jb, tb = pair(_normal((n,), 6), "float32") if bias else (None, None)
    K.reset_launches()
    got = L.dense(tx, tw, tb)
    assert K.launch_counts()["plain_matmul"] == 1
    assert got.dtype == tx.dtype and got.shape == (*shape[:-1], n)
    assert_lm_close(got, JL.dense(jx, jw, jb), dtype)


@pytest.mark.parametrize("kind", ["silu", "gelu"])
def test_act(kind):
    jx, tx = pair(_normal((4, 33), 7, 3.0), "float32")
    assert_lm_close(L._act(tx, kind), JL._act(jx, kind), "float32")
    with pytest.raises(ValueError, match="unknown act"):
        L._act(tx, "relu")


def _qkv(b, sq, skv, hkv, g, d, dtype, seed):
    jq, tq = pair(_normal((b, sq, hkv, g, d), seed), dtype)
    jk, tk = pair(_normal((b, skv, hkv, d), seed + 1), dtype)
    jv, tv = pair(_normal((b, skv, hkv, d), seed + 2), dtype)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal,qc,kc", [
    (12, 12, True, 5, 7),     # ragged lengths: both axes padded
    (8, 20, True, 8, 8),      # q offset into a longer KV (skv padded)
    (10, 10, False, 4, 16),   # non-causal (encoder / cross), kv chunk > skv
    (16, 16, True, 16, 16),   # one chunk each
])
def test_online_chunk_attention(sq, skv, causal, qc, kc, dtype):
    j, t = _qkv(2, sq, skv, 2, 3, 8, dtype, 10)
    kw = dict(causal=causal, q_offset=skv - sq, q_chunk=qc, kv_chunk=kc)
    want = JL._online_chunk_attention(*j, **kw)
    got = L._online_chunk_attention(*t, **kw)
    assert got.shape == t[0].shape and got.dtype == t[0].dtype
    assert_lm_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,qc", [(24, 8, 8), (20, 16, 8),
                                         (18, 5, 512)])
def test_banded_window_attention(s, window, qc, dtype):
    j, t = _qkv(1, s, s, 2, 2, 8, dtype, 20)
    kw = dict(window=window, q_offset=0, q_chunk=qc)
    want = JL._banded_window_attention(*j, **kw)
    got = L._banded_window_attention(*t, **kw)
    assert_lm_close(got, want, dtype)


def test_banded_window_is_the_windowed_softmax():
    """The band is the window: against the full causal scan masked by
    hand in numpy."""
    _, (q, k, v) = _qkv(1, 16, 16, 1, 2, 8, "float32", 30)
    got = L._banded_window_attention(q, k, v, window=4, q_offset=0,
                                     q_chunk=8)
    qn, kn, vn = (f64(x) for x in (q, k, v))
    s = np.einsum("bqhgd,bkhd->bhgqk", qn * 8 ** -0.5, kn)
    i, j = np.arange(16)[:, None], np.arange(16)[None]
    s = np.where((j <= i) & (j > i - 4), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bhgqk,bkhd->bqhgd", p, vn)
    np.testing.assert_allclose(f64(got), want, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ring(dtype):
    """A ring buffer of 6 slots: one sequence still filling (3 valid), one
    wrapped (all valid)."""
    j, t = _qkv(2, 1, 6, 2, 2, 8, dtype, 40)
    n_valid = np.array([3, 6], np.int32)
    want = JL._decode_attention(*j, jnp.asarray(n_valid))
    got = L._decode_attention(*t, torch.from_numpy(n_valid))
    assert got.shape == t[0].shape
    assert_lm_close(got, want, dtype)


def test_write_kv_cache_ring_and_leaves_its_input():
    kc, vc = torch.zeros(2, 4, 1, 3), torch.zeros(2, 4, 1, 3)
    jkc = jnp.zeros((2, 4, 1, 3))
    kn = torch.from_numpy(_normal((2, 1, 3), 50))
    pos = np.array([2, 9], np.int32)
    k2, v2, nv = L.write_kv_cache(kc, vc, kn, kn, torch.from_numpy(pos))
    jk2, _, jnv = JL.write_kv_cache(jkc, jkc, jnp.asarray(kn.numpy()),
                                    jnp.asarray(kn.numpy()),
                                    jnp.asarray(pos))
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    assert kc.abs().sum() == 0          # the buffer passed in is unchanged
    assert k2[1, 9 % 4].abs().sum() > 0


ARCHS = ["qwen3-1.7b", "qwen1.5-110b", "starcoder2-15b", "granite-34b",
         "mixtral-8x7b"]


def _block_case(arch, dtype, seed=0):
    cfg = get_config(arch, smoke=True).replace(compute_dtype=dtype)
    jcfg = jget(arch, smoke=True).replace(compute_dtype=dtype)
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return cfg, jcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_prefill_gqa(arch, dtype):
    """GQA grouping (qg = (B,S,Hkv,G,D)), qk-norm, qkv bias, RoPE, and the
    sliding-window band (mixtral, window 16 < 24)."""
    cfg, jcfg, jp, tp = _block_case(arch, dtype)
    jx, tx = pair(_normal((2, 24, cfg.d_model), 60), dtype)
    jout, (jk, jv) = JL.attention_block(jcfg, jp, jx, q_chunk=8, kv_chunk=8)
    out, (k, v) = L.attention_block(cfg, tp, tx, q_chunk=8, kv_chunk=8)
    assert_lm_close(out, jout, dtype)
    assert_lm_close(k, jk, dtype)
    assert_lm_close(v, jv, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_block_decode(arch):
    cfg, jcfg, jp, tp = _block_case(arch, "float32")
    jx, tx = pair(_normal((2, 1, cfg.d_model), 61), "float32")
    jc, tc = pair(_normal((2, 8, cfg.n_kv_heads, cfg.d_head), 62), "float32")
    pos = np.array([5, 11], np.int32)
    kw = dict(positions=jnp.asarray(pos)[:, None])
    jout, (jk, _) = JL.attention_block(jcfg, jp, jx,
                                       kv_cache=(jc, jc, jnp.asarray(pos)),
                                       **kw)
    out, (k, _) = L.attention_block(
        cfg, tp, tx, kv_cache=(tc, tc, torch.from_numpy(pos)),
        positions=torch.from_numpy(pos)[:, None])
    assert_lm_close(out, jout, "float32")
    assert_lm_close(k, jk, "float32")


def test_pick_chunks_defaults_and_tuned_entry(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "cache.json"))
    autotune.clear_memory_cache()
    assert L._pick_chunks(256, 256, 64, torch.float32, "cpu") == (512, 1024)
    autotune.record(256, 256, 64, (64, 128), dtype=torch.float32,
                    backend="cpu", kernel="attention")
    assert L._pick_chunks(256, 256, 64, torch.float32, "cpu") == (64, 128)
    autotune.clear_memory_cache()


def test_shard_ctx_is_single_device_only():
    """Without a mesh ``ShardCtx`` places nothing; a mesh must be a
    ``DeviceMesh`` (the mesh itself: ``tests/test_torch_sharding.py``)."""
    assert L.NO_SHARD.mesh is None
    x = torch.ones(2, 3)
    assert L.NO_SHARD.shard(x, "data", "model") is x
    assert L.NO_SHARD.activation(x) is x
    with pytest.raises(ValueError, match="DeviceMesh"):
        L.ShardCtx(mesh=object())


def _moe_case(dtype, s=12, seed=1):
    cfg = get_config("mixtral-8x7b", smoke=True).replace(compute_dtype=dtype)
    jcfg = jget("mixtral-8x7b", smoke=True).replace(compute_dtype=dtype)
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    jx, tx = pair(_normal((3, s, cfg.d_model), 70), dtype)
    return cfg, jcfg, jp, tp, jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_moe_block(cf, dtype):
    """cf 1.0 drops tokens beyond capacity (the dump row); 2.0 is the
    serving capacity."""
    cfg, jcfg, jp, tp, jx, tx = _moe_case(dtype)
    jy, jprobs = JL.moe_block(jcfg, jp, jx, capacity_factor=cf)
    K.reset_launches()
    y, probs = L.moe_block(cfg, tp, tx, capacity_factor=cf)
    # one router product for the batch, then 3 per expert
    assert K.launch_counts()["plain_matmul"] == 1 + 3 * cfg.n_experts
    assert_lm_close(y, jy, dtype)
    assert_lm_close(probs, jprobs, "float32")


def test_moe_top_k_ties_break_towards_the_lower_expert():
    """Equal router scores (a zero router): lax.top_k picks experts 0 and
    1; so must the port, or dispatch would differ."""
    cfg, jcfg, jp, tp, jx, tx = _moe_case("float32", s=4)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    buf, _, _ = L._moe_dispatch(cfg, tp, tx, cap=4)
    jbuf = jax.vmap(lambda xx: JL._moe_dispatch_one(jcfg, jp, xx, 4)[0])(jx)
    assert_lm_close(buf, jbuf, "float32")
    assert buf[:, 2:].abs().sum() == 0      # experts 2, 3 get nothing
