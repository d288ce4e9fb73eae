"""``core.scan`` against the reference's: the doubling scan over a tensor,
a tuple and a dict, ``prefix_products`` in f32 and bf16 (fp32
accumulation) both ways, and ``decay_prefix``.

Tolerance: ``DENSE_BUDGET`` of the dtype (float32 (2e-3, 1e-5), bfloat16
(0.15, 0.05)), as ``(rtol, atol)``. ``prefix_products``' ``torch.matmul``
runs with ``exact_matmul_settings()`` in force: TF32 off and no
reduced-precision bf16 / f16 reductions (checked below).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import scan as jscan
from repro_torch.core import decay_prefix, prefix_products, prefix_scan

from _torch_lm import assert_lm_close
from _torch_parity import pair


def _ssd_combine_jax(older, newer):
    a1, s1 = older
    a2, s2 = newer
    return a1 * a2, a2[..., None, None] * s1 + s2


def _ssd_combine_torch(older, newer):
    a1, s1 = older
    a2, s2 = newer
    return a1 * a2, a2[..., None, None] * s1 + s2


@pytest.mark.parametrize("t", [1, 2, 5, 8, 13])
def test_prefix_scan_tuple_is_the_ssd_recurrence(t):
    rng = np.random.default_rng(t)
    decay = rng.uniform(0.5, 1.0, (2, t, 3)).astype(np.float32)
    inc = rng.standard_normal((2, t, 3, 4, 5)).astype(np.float32)
    want = jscan.prefix_scan((jnp.asarray(decay), jnp.asarray(inc)),
                             _ssd_combine_jax, axis=1)
    got = prefix_scan((torch.from_numpy(decay), torch.from_numpy(inc)),
                      _ssd_combine_torch, axis=1)
    assert isinstance(got, tuple)
    for g, w in zip(got, want):
        assert_lm_close(g, w, "float32")
    # and the sequential recurrence it stands for
    h = np.zeros((2, 3, 4, 5))
    for i in range(t):
        h = decay[:, i, :, None, None] * h + inc[:, i]
        np.testing.assert_allclose(got[1][:, i].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


def test_prefix_scan_dict_and_tensor():
    x = np.arange(1, 11, dtype=np.float32)
    got = prefix_scan({"a": torch.from_numpy(x)},
                      lambda o, n: {"a": o["a"] + n["a"]})
    np.testing.assert_array_equal(got["a"].numpy(), np.cumsum(x))
    got = prefix_scan(torch.from_numpy(x), lambda o, n: o * n)
    np.testing.assert_allclose(got.numpy(), np.cumprod(x), rtol=1e-6)
    with pytest.raises(TypeError, match="prefix_scan takes"):
        prefix_scan(3.0, lambda o, n: o)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,m,axis", [(7, 4, 0), (9, 3, 1)])
def test_prefix_products(t, m, axis, dtype, reverse):
    rng = np.random.default_rng(t * m)
    shape = (t, m, m) if axis == 0 else (2, t, m, m)
    mats = (np.eye(m) + rng.standard_normal(shape) * 0.3).astype(np.float32)
    jm, tm = pair(mats, dtype)
    want = jscan.prefix_products(jm, axis=axis, reverse=reverse)
    got = prefix_products(tm, axis=axis, reverse=reverse)
    assert got.dtype == tm.dtype and got.shape == tm.shape
    assert_lm_close(got, want, dtype)


def test_prefix_products_convention_and_flags():
    a = torch.tensor([[[1.0, 1.0], [0.0, 1.0]], [[2.0, 0.0], [0.0, 1.0]]])
    got = prefix_products(a)
    torch.testing.assert_close(got[1], a[1] @ a[0])   # newer on the left
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul \
        .allow_bf16_reduced_precision_reduction
    with pytest.raises(ValueError, match="square"):
        prefix_products(torch.zeros(3, 2, 4))


def test_decay_prefix():
    x = np.random.default_rng(0).uniform(-1, 0, (3, 11)).astype(np.float32)
    assert_lm_close(decay_prefix(torch.from_numpy(x)),
                    jscan.decay_prefix(jnp.asarray(x)), "float32")
