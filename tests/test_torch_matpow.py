"""``repro_torch.core.matpow`` vs ``repro.core.matpow`` and numpy.

The same numpy operand goes through the reference (``"xla"`` and the fused
chain in interpret mode) and through the port's three backends on CPU
tensors — where ``"cuda"`` / ``"cuda_chain"`` run the port's padding, tier
and chain logic over the kernels' plain versions. Everything is also held to
``np.linalg.matrix_power`` in float64. Tolerance:
``error_budget(dtype, n, mults)`` with ``mults`` the chain's multiply count;
bit-identity across frameworks is not claimed.
"""

import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _hypothesis_compat import given, settings, strategies as st

from repro.core import matpow as jmatpow
from repro_torch.core import (chain_for, matmul_backend, matpow_binary,
                              matpow_binary_traced, matpow_naive)
from repro_torch.kernels import matmul_kernels as K
from repro_torch.kernels import ops

from _torch_parity import (assert_close, matpow_mults, pair, randn,
                           stochastic)

BACKENDS = ["torch", "cuda", "cuda_chain"]
REF_BACKEND = {"torch": "xla", "cuda": "xla",
               "cuda_chain": "pallas_chain_interpret"}


@pytest.fixture(autouse=True)
def _fresh_counters():
    K.reset_launches()
    yield


def _f64_power(a, p):
    return np.linalg.matrix_power(np.asarray(a, np.float64), p)


class TestOperand:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n", [40, 96, 200])
    @pytest.mark.parametrize("p,wrong", [(96, 64), (96, 32), (96, 128),
                                         (12, 8), (7, 4), (2, 1)])
    def test_a_wrong_exponent_is_outside_the_tolerance(self, n, p, wrong,
                                                       dtype):
        """The checks below can only see a chain that squares too few times
        or combines the wrong operands if the operand's powers differ by
        more than the tolerance: hold the operand itself to that."""
        a = stochastic(n, n + p)
        with pytest.raises(AssertionError):
            assert_close(_f64_power(a, wrong), _f64_power(a, p), dtype, n=n,
                         mults=matpow_mults(p))


class TestBinary:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("p", [0, 1, 2, 7, 12, 96])
    @pytest.mark.parametrize("n", [96, 200])
    def test_vs_numpy_f64(self, n, p, backend):
        _, ta = pair(stochastic(n, n + p), "float32")
        got = matpow_binary(ta, p, backend=backend)
        assert got.shape == (n, n) and got.dtype == torch.float32
        assert_close(got, _f64_power(ta.numpy(), p), "float32", n=n,
                     mults=matpow_mults(p))

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("n,p", [(96, 7), (96, 96), (200, 12)])
    def test_vs_reference(self, n, p, backend):
        ja, ta = pair(stochastic(n, 3 * n + p), "float32")
        want = jmatpow.matpow_binary(ja, p, backend=REF_BACKEND[backend])
        got = matpow_binary(ta, p, backend=backend)
        assert_close(got, want, "float32", n=n, mults=matpow_mults(p))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_bf16_chain_rounds_once_per_multiply(self, backend):
        ja, ta = pair(stochastic(96, 5), "bfloat16")
        want = jmatpow.matpow_binary(ja, 12, backend=REF_BACKEND[backend])
        got = matpow_binary(ta, 12, backend=backend)
        assert got.dtype == torch.bfloat16
        assert_close(got, want, "bfloat16", n=96, mults=4)
        assert_close(got, _f64_power(ta.float().numpy(), 12), "bfloat16",
                     n=96, mults=4)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_stack(self, backend):
        ja, ta = pair(stochastic(40, 6, batch=3), "float32")
        want = jmatpow.matpow_binary(ja, 5, backend="xla")
        got = matpow_binary(ta, 5, backend=backend)
        assert got.shape == (3, 40, 40)
        assert_close(got, want, "float32", n=40, mults=3)

    def test_f64_stays_f64(self):
        a = torch.from_numpy(stochastic(50, 7).astype(np.float64))
        got = matpow_binary(a, 96, backend="cuda_chain")
        assert got.dtype == torch.float64
        assert_close(got, _f64_power(a.numpy(), 96), "float64", n=50, mults=7)

    @given(st.integers(1, 97), st.integers(0, 32))
    @settings(max_examples=15, deadline=None)
    def test_property_any_size_any_power(self, n, p):
        a = torch.from_numpy(stochastic(n, 1000 * n + p))
        want = _f64_power(a.numpy(), p)
        for backend in ("cuda", "cuda_chain"):
            got = matpow_binary(a, p, backend=backend)
            assert_close(got, want, "float32", n=n, mults=matpow_mults(p),
                         err_msg=f"n={n} p={p} {backend}")


class TestNaive:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("n", [96, 200])
    def test_vs_reference_and_numpy(self, n, backend):
        ja, ta = pair(stochastic(n, 10 + n), "float32")
        want = jmatpow.matpow_naive(ja, 5, backend=REF_BACKEND[backend])
        got = matpow_naive(ta, 5, backend=backend)
        assert_close(got, want, "float32", n=n, mults=4)
        assert_close(got, _f64_power(ta.numpy(), 5), "float32", n=n, mults=4)

    def test_launches_one_multiply_per_step(self):
        a = torch.from_numpy(stochastic(40, 11))
        matpow_naive(a, 6, backend="cuda_chain")
        assert K.launch_counts()["plain_matmul"] == 5

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_power_one_returns_a_new_tensor(self, backend):
        a = torch.from_numpy(stochastic(64, 12))
        out = matpow_naive(a, 1, backend=backend)
        assert torch.equal(out, a) and out.data_ptr() != a.data_ptr()


class TestTraced:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("p", [0, 1, 2, 3, 12, 13, 64, 96])
    def test_matches_static_and_reference(self, p, backend):
        ja, ta = pair(stochastic(96, 20 + p), "float32")
        got = matpow_binary_traced(ta, torch.tensor(p, dtype=torch.int32),
                                   backend=backend)
        assert torch.equal(got, matpow_binary(ta, p, backend=backend))
        want = jmatpow.matpow_binary_traced(ja, jnp.int32(p), backend="xla")
        assert_close(got, want, "float32", n=96, mults=matpow_mults(p))

    @pytest.mark.parametrize("n", [3, np.int64(3), torch.tensor(3),
                                   torch.tensor(3, dtype=torch.int64),
                                   np.array(3)])
    def test_accepts_ints_and_0d_integer_tensors(self, n):
        a = torch.from_numpy(stochastic(8, 21))
        assert torch.equal(matpow_binary_traced(a, n, backend="cuda_chain"),
                           matpow_binary(a, 3, backend="cuda_chain"))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_negative_power_clamps_to_identity(self, backend):
        """The static siblings raise for n < 0; a power that is data cannot,
        and must not fall through to A^1 — same as the reference."""
        ja, ta = pair(stochastic(7, 22), "float32")
        got = matpow_binary_traced(ta, torch.tensor(-5), backend=backend)
        want = jmatpow.matpow_binary_traced(ja, jnp.int32(-5))
        np.testing.assert_array_equal(got.numpy(), np.eye(7, dtype=np.float32))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())

    def test_max_bits_bounds_the_loop(self):
        a = torch.eye(4)
        assert torch.equal(matpow_binary_traced(a, 255, max_bits=8), a)
        with pytest.raises(ValueError, match="max_bits"):
            matpow_binary_traced(a, 256, max_bits=8)

    @pytest.mark.parametrize("n", [2.0, torch.tensor(2.0), torch.tensor([2]),
                                   "2", True, None])
    def test_non_integer_power_is_a_type_error(self, n):
        with pytest.raises(TypeError):
            matpow_binary_traced(torch.eye(4), n)


class TestMultiplyCounts:
    @pytest.mark.parametrize("p", [1, 2, 3, 7, 8, 12, 13, 96, 255, 256])
    def test_chain_squarings_and_combines(self, p):
        """Seeded from the first set bit — no identity multiply: exactly
        bit_length(p)-1 squarings and popcount(p)-1 combines."""
        a = torch.eye(40)
        matpow_binary(a, p, backend="cuda_chain")
        counts = K.launch_counts()
        assert counts["plain_square_whole"] == p.bit_length() - 1
        assert counts["plain_matmul"] == bin(p).count("1") - 1
        assert counts["matmul"] == counts["square_whole"] == 0

    @pytest.mark.parametrize("p", [1, 7, 96])
    def test_per_call_route_same_count_through_k1(self, p):
        a = torch.eye(40)
        matpow_binary(a, p, backend="cuda")
        expected = matpow_mults(p) if p > 1 else 0
        assert K.launch_counts()["plain_matmul"] == expected

    def test_traced_uses_the_same_count(self):
        a = torch.eye(40)
        matpow_binary_traced(a, torch.tensor(96), backend="cuda_chain")
        counts = K.launch_counts()
        assert counts["plain_square_whole"] == 6
        assert counts["plain_matmul"] == 1

    def test_power_zero_launches_nothing(self):
        matpow_binary(torch.eye(40), 0, backend="cuda_chain")
        assert not any(K.launch_counts().values())


class TestContracts:
    ENTRY = [matpow_naive, matpow_binary]

    @pytest.mark.parametrize("fn", ENTRY)
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_empty_matrix_raises(self, fn, backend):
        with pytest.raises(ValueError, match="n >= 1"):
            fn(torch.zeros(0, 0), 3, backend=backend)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_empty_matrix_raises_traced(self, backend):
        with pytest.raises(ValueError, match="n >= 1"):
            matpow_binary_traced(torch.zeros(0, 0), 3, backend=backend)

    @pytest.mark.parametrize("fn", ENTRY)
    @pytest.mark.parametrize("shape", [(3, 4), (5,), (2, 3, 4)])
    def test_non_square_raises(self, fn, shape):
        with pytest.raises(ValueError, match="square"):
            fn(torch.zeros(shape), 2)

    @pytest.mark.parametrize("fn", ENTRY)
    @pytest.mark.parametrize("p", [2.0, "3", None, torch.tensor(2), True])
    def test_non_int_power_is_a_type_error(self, fn, p):
        with pytest.raises(TypeError, match="python int"):
            fn(torch.eye(4), p)

    @pytest.mark.parametrize("fn", ENTRY)
    def test_negative_power_raises(self, fn):
        with pytest.raises(ValueError, match="negative"):
            fn(torch.eye(4), -1)

    @pytest.mark.parametrize("fn", ENTRY)
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("shape", [(7, 7), (3, 7, 7)])
    def test_power_zero_is_identity(self, fn, backend, shape):
        a = torch.from_numpy(randn(shape, 30))
        got = fn(a, 0, backend=backend)
        assert got.shape == shape
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(np.eye(7, dtype=np.float32), shape))

    @pytest.mark.parametrize("backend", ["pallas", "xla", "triton", "",
                                         "pallas_fastmm", "cuda_fastmm",
                                         "fastmm", "cuda_chain_interpret"])
    def test_unknown_and_unported_backends_raise(self, backend):
        """The Strassen routes are not ported yet: their names must raise,
        not quietly run dense."""
        with pytest.raises(ValueError, match="unknown matmul backend"):
            matmul_backend(backend)
        with pytest.raises(ValueError, match="unknown matmul backend"):
            matpow_binary(torch.eye(4), 3, backend=backend)
        with pytest.raises(ValueError, match="unknown matmul backend"):
            chain_for(torch.eye(4), backend)

    def test_chain_for_only_on_the_chain_backend(self):
        a = torch.eye(8)
        assert chain_for(a, "torch") is None
        assert chain_for(a, "cuda") is None
        chain = chain_for(a, "cuda_chain")
        assert isinstance(chain, ops.MatmulChain) and chain.n == 8
        assert chain.donate and not chain_for(a, "cuda_chain",
                                              donate=False).donate

    def test_bare_backend_callables_multiply(self):
        a = torch.from_numpy(randn((20, 30), 31, 0.3))
        b = torch.from_numpy(randn((30, 10), 32, 0.3))
        want = a.double().numpy() @ b.double().numpy()
        for backend in BACKENDS:
            assert_close(matmul_backend(backend)(a, b), want, "float32", n=30)

    def test_precision_matches_the_reference_signature(self):
        """``matmul_backend(backend, precision=None)`` as in the reference:
        the same parameter names and defaults after the backend's own."""
        ref = inspect.signature(jmatpow.matmul_backend).parameters
        port = inspect.signature(matmul_backend).parameters
        assert list(port) == list(ref) == ["backend", "precision"]
        assert port["precision"].default is ref["precision"].default is None

    @pytest.mark.parametrize("precision", [None, "highest", "HIGHEST",
                                           "float32"])
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_exact_precisions_return_the_route(self, backend, precision):
        a = torch.from_numpy(randn((20, 30), 33, 0.3))
        b = torch.from_numpy(randn((30, 10), 34, 0.3))
        mm = matmul_backend(backend, precision=precision)
        assert callable(mm)
        assert_close(mm(a, b), a.double().numpy() @ b.double().numpy(),
                     "float32", n=30)
        assert matmul_backend(backend, precision) is mm

    @pytest.mark.parametrize("precision", ["default", "high", "bfloat16",
                                           "tf32", 0])
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_other_precisions_raise_naming_the_route(self, backend,
                                                     precision):
        with pytest.raises(ValueError, match=repr(backend)):
            matmul_backend(backend, precision=precision)

    def test_unknown_backend_raises_before_precision(self):
        with pytest.raises(ValueError, match="unknown matmul backend"):
            matmul_backend("xla", precision="default")

    def test_torch_backend_sets_full_precision_accumulation(self):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            matmul_backend("torch")
            assert torch.backends.cuda.matmul.allow_tf32 is False
            mm = torch.backends.cuda.matmul
            assert mm.allow_bf16_reduced_precision_reduction is False
            assert mm.allow_fp16_reduced_precision_reduction is False
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False


class TestBoolPower:
    """A deliberate difference from the reference: its check
    ``isinstance(n, int)`` lets ``matpow_binary(a, True)`` run as p = 1;
    every entry point of the port refuses a bool power with ``TypeError``
    (a bool is an int in Python, and never a power anyone meant)."""

    @pytest.mark.parametrize("power", [True, False])
    def test_every_entry_point_refuses_a_bool(self, power):
        from repro_torch.core import batched_matpow
        a = torch.eye(4)
        for fn in (matpow_naive, matpow_binary):
            with pytest.raises(TypeError):
                fn(a, power)
        with pytest.raises(TypeError):
            matpow_binary_traced(a, power)
        with pytest.raises(TypeError):
            batched_matpow(a[None], power, backend="cuda_chain")

    def test_the_reference_runs_a_bool_as_a_power(self):
        a = 2.0 * np.eye(3, dtype=np.float32)
        got = np.asarray(jmatpow.matpow_binary(jnp.asarray(a), True))
        np.testing.assert_array_equal(got, a)
