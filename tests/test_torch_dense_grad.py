"""``ops.dense_matmul``'s backward against the reference's custom VJP.

The reference's ``_dense_2d`` computes ``dx = g @ w.T`` and ``dw = x.T @ g``
through its tiled kernel K1. Its tests run that VJP on the CPU with
``REPRO_DENSE_PALLAS=interpret`` (read at call time; set here with
``monkeypatch``); the port's ``_Dense2d`` runs the same three products as
K1's plain version on CPU tensors. Same numpy inputs, ``DENSE_BUDGET
["float32"]`` (rtol 2e-3, atol 1e-5), ragged shapes that pad to the tile.
``gradcheck`` in float64 checks the backward against finite differences.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parity  # noqa: F401  (the port's tuning cache off ~/.cache)
from repro.kernels import ops as jops
from repro_torch.kernels import DENSE_BUDGET, ops
from repro_torch.kernels import matmul_kernels as K


def _inputs(x_shape, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal((x_shape[-1], n)).astype(np.float32)
    g = rng.standard_normal(x_shape[:-1] + (n,)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("x_shape,n", [((5, 24), 40), ((2, 3, 24), 40),
                                       ((24,), 8), ((33, 70), 65)])
def test_grads_match_the_reference_custom_vjp(monkeypatch, x_shape, n):
    monkeypatch.setenv("REPRO_DENSE_PALLAS", "interpret")
    assert jops.dense_routing_active()
    x, w, g = _inputs(x_shape, n, seed=len(x_shape) + n)
    y, vjp = jax.vjp(jops.dense_matmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = ops.dense_matmul(tx, tw)
    out.backward(torch.from_numpy(g))
    rtol, atol = DENSE_BUDGET["float32"]
    for got, want in ((out, y), (tx.grad, jdx), (tw.grad, jdw)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=rtol, atol=atol)


def test_jax_grad_of_a_loss_through_the_reference_kernel(monkeypatch):
    """``jax.grad`` of a scalar loss (the form a train step takes) against
    ``torch.autograd.grad`` of the same loss."""
    monkeypatch.setenv("REPRO_DENSE_PALLAS", "interpret")
    x, w, _ = _inputs((5, 24), 40, seed=3)

    def jloss(a, b):
        return jnp.sum(jnp.tanh(jops.dense_matmul(a, b)))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    dx, dw = torch.autograd.grad(
        torch.sum(torch.tanh(ops.dense_matmul(tx, tw))), (tx, tw))
    rtol, atol = DENSE_BUDGET["float32"]
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("x_shape,n", [((5, 12), 7), ((2, 3, 7), 5)])
def test_gradcheck_f64(x_shape, n):
    x, w, _ = _inputs(x_shape, n)
    tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    tw = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ops.dense_matmul, (tx, tw))


@pytest.mark.parametrize("needs", [(True, True), (True, False),
                                   (False, True)])
def test_a_backward_launches_k1_once_per_gradient(needs):
    """The forward is one launch; the backward one more for each operand
    that requires a gradient: 2 per call in training."""
    x, w, g = _inputs((5, 24), 40)
    tx = torch.tensor(x, requires_grad=needs[0])
    tw = torch.tensor(w, requires_grad=needs[1])
    K.reset_launches()
    out = ops.dense_matmul(tx, tw)
    assert K.launch_counts()["plain_matmul"] == 1
    out.backward(torch.from_numpy(g))
    assert K.launch_counts()["plain_matmul"] == 1 + sum(needs)
    assert (tx.grad is not None, tw.grad is not None) == needs


def test_each_transposed_problem_picks_its_own_tiles(monkeypatch):
    seen = []
    real = ops.pick_blocks

    def spy(m, n, k, **kw):
        seen.append((m, n, k))
        return real(m, n, k, **kw)

    monkeypatch.setattr(ops, "pick_blocks", spy)
    x, w, g = _inputs((5, 24), 40)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ops.dense_matmul(tx, tw).backward(torch.from_numpy(g))
    # forward (M, N, K), dx (M, K, N), dw (K, N, M)
    assert seen == [(5, 40, 24), (5, 24, 40), (24, 40, 5)]


def test_gradient_dtypes_follow_the_operands():
    x, w, g = _inputs((4, 16), 8)
    tx = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    tw = torch.tensor(w, dtype=torch.bfloat16, requires_grad=True)
    ops.dense_matmul(tx, tw).backward(torch.from_numpy(g).bfloat16())
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    want = g @ w.astype(np.float32).T
    rtol, atol = DENSE_BUDGET["bfloat16"]
    np.testing.assert_allclose(tx.grad.float().numpy(), want, rtol=rtol,
                               atol=atol)


def test_the_forward_under_autograd_is_one_dispatcher_op():
    """Under grad the forward product is the op ``DENSE_MM_OP`` that the
    remat policies look for, carrying the ``name`` tag; without grad it is
    not dispatched at all (serving pays nothing for it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func == ops.DENSE_MM_OP:
                self.ops.append(args[2])
            return func(*args, **(kwargs or {}))

    x, w, _ = _inputs((5, 24), 40)
    tw = torch.tensor(w, requires_grad=True)
    with Seen() as seen:
        ops.dense_matmul(torch.from_numpy(x), tw, name="proj_out")
        with torch.no_grad():
            ops.dense_matmul(torch.from_numpy(x), tw, name="block_out")
    assert seen.ops == ["proj_out"]


def test_pallas_supported_means_the_card():
    assert ops.pallas_supported("cpu") is False
    assert ops.pallas_supported() is torch.cuda.is_available()
