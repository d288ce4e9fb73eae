"""Shared plumbing of the LM parity tests (``tests/test_torch_{model,
layers,ssm,lm_serve}.py``).

Inputs are made from a numpy seed and go, as the same values, through the
reference (JAX on the CPU, where ``dense_matmul`` is its einsum) and the
port (CPU tensors, where every wrapper runs its kernel's plain version).
Weights are the reference's ``init_params``, carried across by
``convert.params_from_reference``. The tolerance is ``DENSE_BUDGET`` of the
config's compute dtype, as ``(rtol, atol)`` of an elementwise
``assert_allclose``: float32 (2e-3, 1e-5) for the smoke configs, bfloat16
(0.15, 0.05) for their bf16 variants.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import _torch_parity  # noqa: F401  (the port's tuning cache off ~/.cache)
from repro import models as jmodels
from repro_torch import convert
from repro_torch.kernels import DENSE_BUDGET


def ref_params(jcfg, seed=0):
    """The reference's weights for ``jcfg`` and the port's copy of them."""
    jp = jmodels.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                             device="cpu")


def lm_inputs(cfg, b, s, seed=7):
    """(numpy tokens, numpy stub inputs) for one batch: int32 tokens and,
    for audio / vlm configs, float32 frames / vision embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        kw["vision_embeds"] = (rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, kw


def to_jax(toks, kw):
    return jnp.asarray(toks), {k: jnp.asarray(v) for k, v in kw.items()}


def to_torch(toks, kw):
    return (convert.from_reference(toks, device="cpu"),
            {k: convert.from_reference(v, device="cpu")
             for k, v in kw.items()})


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).astype(np.float64)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.astype(np.float32)
    return x.astype(np.float64)


def budget(dtype_name: str):
    """(rtol, atol) the LM tests hold the port to: ``DENSE_BUDGET``."""
    return DENSE_BUDGET[dtype_name]


def assert_lm_close(got, want, dtype_name: str, what: str = ""):
    rtol, atol = budget(dtype_name)
    g, w = f64(got), f64(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
