"""Remat in the port: ``models.model._maybe_remat`` and the attention
chunk-body checkpoint (``models.layers._maybe_ckpt_body``).

A layer stack under each of the reference's three policies gives the loss
and gradients it gives with ``remat=False`` (held to ``DENSE_BUDGET
["float32"]``; recomputation runs the same operations on the same inputs),
and the count of K1 launches in its backward (K1's plain version here:
``plain_matmul``) says what was recomputed: 2 per projection, plus every
forward product under ``"nothing"``, none of the tagged projections under
``"proj"`` (the reference's ``checkpoint_name`` tags: q / k / v, wo and the
MLP's; the SSM and MoE products carry none, as in the reference), and no
``dense_matmul`` product under ``"dots"``. With ``attention_bwd=
"recompute"`` the chunked attention's gradients are those of ``"stash"``,
and its backward keeps fewer bytes of saved activations.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (the port's tuning cache off ~/.cache)
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.kernels import DENSE_BUDGET
from repro_torch.kernels import matmul_kernels as K
from repro_torch.models import layers as L
from repro_torch.models import model as M

RTOL, ATOL = DENSE_BUDGET["float32"]


def _leaves(tree):
    out = []
    M._map(out.append, tree)
    return out


def _loss_and_grads(cfg, p0, toks):
    p = M._map(lambda x: x.detach().clone().requires_grad_(), p0)
    K.reset_launches()
    out = models.forward(cfg, p, toks)
    loss = models.unembed(cfg, p, out["x"]).logsumexp(-1).mean() + out["aux"]
    fwd = K.launch_counts()["plain_matmul"]
    leaves = _leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    bwd = K.launch_counts()["plain_matmul"] - fwd
    return loss, grads, fwd, bwd


#: (arch, K1 products a forward, of which tagged proj_out / block_out)
ARCHS = [("qwen3-1.7b", 14, 14), ("mamba2-130m", 4, 0),
         ("mixtral-8x7b", 34, 8)]


@pytest.mark.parametrize("policy", ["nothing", "dots", "proj"])
@pytest.mark.parametrize("arch,products,tagged", ARCHS)
def test_policy_matches_no_remat_and_recomputes_what_it_should(
        arch, products, tagged, policy):
    cfg0 = get_config(arch, smoke=True)
    p0 = models.init_params(cfg0, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg0.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss0, grads0, fwd0, bwd0 = _loss_and_grads(cfg0.replace(remat=False),
                                                p0, toks)
    assert (fwd0, bwd0) == (products, 2 * products)
    loss, grads, fwd, bwd = _loss_and_grads(
        cfg0.replace(remat=True, remat_policy=policy), p0, toks)
    recomputed = {"nothing": products, "dots": 0,
                  "proj": products - tagged}[policy]
    assert fwd == products
    assert bwd == 2 * products + recomputed
    np.testing.assert_allclose(loss.item(), loss0.item(), rtol=RTOL,
                               atol=ATOL)
    for g, g0 in zip(grads, grads0):
        assert (g is None) == (g0 is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_unknown_policy_refused():
    cfg = get_config("qwen3-1.7b", smoke=True).replace(remat_policy="all")
    with pytest.raises(ValueError, match="remat_policy"):
        M._maybe_remat(lambda x: x, cfg)


def test_serving_runs_no_checkpoint():
    """Without grad a remat config runs its layer bodies as they are."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    assert cfg.remat
    calls = []
    body = M._maybe_remat(lambda x: calls.append(torch.is_grad_enabled())
                          or x, cfg)
    with torch.no_grad():
        body(torch.ones(2, requires_grad=True))
    assert calls == [False]


def test_layers_unbind_once():
    """``_layers`` gives each layer's tree as views of one ``unbind`` per
    stacked leaf: the weights' gradient flows back as one stack."""
    stack = {"a": torch.randn(3, 4, requires_grad=True),
             "b": {"c": torch.randn(3, 2, requires_grad=True)}}
    layers = M._layers(stack)
    assert len(layers) == 3
    for i, layer in enumerate(layers):
        assert torch.equal(layer["a"], stack["a"][i])
        assert torch.equal(layer["b"]["c"], stack["b"]["c"][i])
    assert layers[0]["a"].grad_fn.name().startswith("Unbind")


def _saved_bytes(fn):
    """(``fn()``, bytes of the distinct storages autograd saved for its
    backward)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


@pytest.mark.parametrize("arch,seq", [("qwen3-1.7b", 16),
                                      ("mixtral-8x7b", 32)])
def test_chunk_body_checkpoint_matches_stash(arch, seq):
    """Several query and KV chunks (mixtral's window of 16 at 32 tokens
    takes the banded path): the same output and gradients, fewer saved
    bytes."""
    rng = np.random.default_rng(4)
    res = {}
    for mode in ("recompute", "stash"):
        cfg = get_config(arch, smoke=True).replace(attention_bwd=mode)
        p = models.init_params(cfg, torch.Generator().manual_seed(2))
        attn = M._map(lambda t: t.detach().requires_grad_(),
                      M._layer(p["blocks"], 0)["attn"])
        x = torch.tensor(rng.standard_normal((2, seq, cfg.d_model)).astype(
            np.float32), requires_grad=True) if mode == "recompute" else \
            res["recompute"][3].detach().clone().requires_grad_()
        out, saved = _saved_bytes(lambda: L.attention_block(
            cfg, attn, x, q_chunk=4, kv_chunk=8)[0])
        grads = torch.autograd.grad(out.square().sum(), [x] + _leaves(attn))
        res[mode] = (out, grads, saved, x)
    out, grads, saved, _ = res["recompute"]
    out0, grads0, saved0, _ = res["stash"]
    np.testing.assert_allclose(out.detach().numpy(), out0.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    for g, g0 in zip(grads, grads0):
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert saved < saved0
