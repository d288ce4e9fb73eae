"""``models/ssm.py`` (the Mamba-2 SSD block) against the reference's.

The mamba2 smoke config (chunk 8) at S = 32 runs four chunks, so the
inter-chunk recurrence goes through two doubling levels of
``prefix_scan``. Tolerance: ``DENSE_BUDGET`` of the compute dtype as
``(rtol, atol)`` (float32 (2e-3, 1e-5); bfloat16 (0.15, 0.05)); the SSD
products are fp32 ``torch.einsum`` calls with ``exact_matmul_settings()``
in force.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import ssm as JS
from repro_torch import convert, exact_matmul_settings
from repro_torch.configs import get_config
from repro_torch.kernels import matmul_kernels as K
from repro_torch.models import ssm as S

from _torch_lm import assert_lm_close
from _torch_parity import pair

exact_matmul_settings()


def _case(dtype, arch="mamba2-130m", seed=0):
    cfg = get_config(arch, smoke=True).replace(compute_dtype=dtype)
    jcfg = jget(arch, smoke=True).replace(compute_dtype=dtype)
    jp = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    return cfg, jcfg, jp, tp


def _x(cfg, s, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model))
    return pair(x.astype(np.float32), dtype)


def _state(cfg, seed):
    st = np.random.default_rng(seed).standard_normal(
        (2, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state)) * 0.3
    conv_dim = cfg.d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    cv = np.random.default_rng(seed + 1).standard_normal(
        (2, cfg.ssm_conv_width - 1, conv_dim)) * 0.3
    return st.astype(np.float32), cv.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [32, 12, 8])
def test_ssm_block(s, dtype):
    """S = 32: 4 chunks; 12: chunk halves to 4, 3 chunks; 8: one chunk."""
    cfg, jcfg, jp, tp = _case(dtype)
    jx, tx = _x(cfg, s, dtype)
    want, (jst, jcv) = JS.ssm_block(jcfg, jp, jx, return_state=True)
    K.reset_launches()
    got, (st, cv) = S.ssm_block(cfg, tp, tx, return_state=True)
    assert K.launch_counts()["plain_matmul"] == 2     # w_in, w_out
    assert got.dtype == tx.dtype
    assert_lm_close(got, want, dtype)
    assert st.dtype == torch.float32
    assert_lm_close(st, jst, dtype)
    assert_lm_close(cv, jcv, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_with_initial_state(dtype):
    cfg, jcfg, jp, tp = _case(dtype)
    jx, tx = _x(cfg, 24, dtype)
    st, cv = _state(cfg, 5)
    jcv = jnp.asarray(cv, jnp.float32).astype(jx.dtype)
    want, (jst2, _) = JS.ssm_block(jcfg, jp, jx, initial_state=jnp.asarray(st),
                                   conv_state=jcv, return_state=True)
    got, (st2, _) = S.ssm_block(cfg, tp, tx,
                                initial_state=torch.from_numpy(st),
                                conv_state=convert.from_reference(
                                    np.asarray(jcv), device="cpu"),
                                return_state=True)
    assert_lm_close(got, want, dtype)
    assert_lm_close(st2, jst2, dtype)


def test_block_equals_stepwise_decode():
    """The chunked scan and the O(1) recurrence are one model: a prompt run
    through ``ssm_block`` ends in the state that decoding it token by token
    reaches."""
    cfg, _, _, tp = _case("float32")
    _, tx = _x(cfg, 16, "float32", seed=3)
    out, (st, cv) = S.ssm_block(cfg, tp, tx, return_state=True)
    h = torch.zeros(2, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state)
    c = torch.zeros(2, cfg.ssm_conv_width - 1, cv.shape[-1])
    for t in range(16):
        y, h, c = S.ssm_decode_step(cfg, tp, tx[:, t:t + 1], h, c)
        torch.testing.assert_close(y, out[:, t:t + 1], rtol=2e-3, atol=1e-5)
    torch.testing.assert_close(h, st, rtol=2e-3, atol=1e-5)
    torch.testing.assert_close(c, cv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_step(dtype):
    cfg, jcfg, jp, tp = _case(dtype)
    jx, tx = _x(cfg, 1, dtype, seed=9)
    st, cv = _state(cfg, 11)
    jcv, tcv = pair(cv, dtype)
    want = JS.ssm_decode_step(jcfg, jp, jx, jnp.asarray(st), jcv)
    got = S.ssm_decode_step(cfg, tp, tx, torch.from_numpy(st), tcv)
    for g, w in zip(got, want):
        assert_lm_close(g, w, dtype)


def test_zamba2_ssm_shapes():
    cfg, jcfg, jp, tp = _case("float32", arch="zamba2-1.2b", seed=2)
    jx, tx = _x(cfg, 16, "float32")
    assert_lm_close(S.ssm_block(cfg, tp, tx), JS.ssm_block(jcfg, jp, jx),
                    "float32")


def test_causal_conv():
    u = np.random.default_rng(0).standard_normal((2, 7, 5)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    b = np.arange(5, dtype=np.float32)
    jy, jst = JS._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b))
    y, st = S._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                           torch.from_numpy(b))
    assert_lm_close(y, jy, "float32")
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
