"""``repro_torch.core.batched`` / ``core.expm`` vs the reference and scipy.

Same numpy stacks through ``repro.core.batched`` / ``repro.core.expm`` and
their port counterparts on CPU tensors. Tolerance:
``error_budget(dtype, n, mults)``; for ``expm`` the multiply count is the
Pade polynomial plus the squarings.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from repro.core import batched as jbatched
from repro.core.expm import expm as jexpm
from repro_torch.core import (BatchedMatmulChain, batched_expm,
                              batched_matpow, expm)
from repro_torch.kernels import matmul_kernels as K

from _torch_parity import (assert_close, matpow_mults, pair, randn,
                           stochastic)

BACKENDS = ["torch", "cuda", "cuda_chain"]


@pytest.fixture(autouse=True)
def _fresh_counters():
    K.reset_launches()
    yield


class TestBatchedMatpow:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("p", [1, 2, 7, 96])
    def test_chain_vs_reference(self, p, dtype):
        ja, ta = pair(stochastic(40, 40 + p, batch=3), dtype)
        want = jbatched.batched_matpow(ja, p, backend="xla")
        got = batched_matpow(ta, p, backend="cuda_chain")
        assert got.shape == (3, 40, 40) and got.dtype == ta.dtype
        assert_close(got, want, dtype, n=40, mults=matpow_mults(p))
        ref64 = np.linalg.matrix_power(ta.double().numpy(), p)
        assert_close(got, ref64, dtype, n=40, mults=matpow_mults(p))

    def test_chain_vs_reference_chain_interpret(self):
        ja, ta = pair(stochastic(40, 50, batch=2), "float32")
        want = jbatched.batched_matpow(ja, 7,
                                       backend="pallas_chain_interpret")
        got = batched_matpow(ta, 7, backend="cuda_chain")
        assert_close(got, want, "float32", n=40, mults=4)

    @pytest.mark.parametrize("backend", ["torch", "cuda"])
    def test_other_backends_fall_through_to_matpow_binary(self, backend):
        a = torch.from_numpy(stochastic(24, 51, batch=4))
        got = batched_matpow(a, 5, backend=backend)
        assert_close(got, np.linalg.matrix_power(a.double().numpy(), 5),
                     "float32", n=24, mults=3)

    def test_one_launch_per_stacked_multiply(self):
        a = torch.from_numpy(stochastic(40, 52, batch=5))
        batched_matpow(a, 7, backend="cuda_chain")
        counts = K.launch_counts()
        assert counts["plain_square_whole"] == 2      # not 2 x 5
        assert counts["plain_matmul"] == 2

    def test_callers_stack_is_never_written(self):
        a = torch.from_numpy(stochastic(64, 53, batch=2))
        keep = a.clone()
        batched_matpow(a, 12, backend="cuda_chain")
        assert torch.equal(a, keep)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_power_zero_is_a_stack_of_identities(self, backend):
        a = torch.from_numpy(randn((3, 6, 6), 54))
        got = batched_matpow(a, 0, backend=backend)
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(np.eye(6, dtype=np.float32),
                                         (3, 6, 6)))

    @pytest.mark.parametrize("shape", [(6, 6), (2, 3, 6, 6), (3, 6, 5)])
    def test_shape_contract(self, shape):
        with pytest.raises(ValueError, match=r"stacked \(B, n, n\)"):
            batched_matpow(torch.zeros(shape), 2)
        with pytest.raises(ValueError, match=r"stacked \(B, n, n\)"):
            batched_expm(torch.zeros(shape))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_empty_matrices_raise(self, backend):
        with pytest.raises(ValueError, match="n >= 1"):
            batched_matpow(torch.zeros(2, 0, 0), 3, backend=backend)

    def test_power_contracts(self):
        a = torch.zeros(2, 4, 4)
        with pytest.raises(TypeError, match="python int"):
            batched_matpow(a, 2.0)
        with pytest.raises(ValueError, match="negative"):
            batched_matpow(a, -1)
        with pytest.raises(ValueError, match="unknown matmul backend"):
            batched_matpow(a, 2, backend="pallas_fastmm")

    def test_chain_pins_its_batch(self):
        chain = BatchedMatmulChain(3, 8, torch.float32)
        with pytest.raises(ValueError, match="expects a"):
            chain.pad(torch.zeros(2, 8, 8))
        with pytest.raises(ValueError, match="expects a"):
            chain.pad(torch.zeros(8, 8))
        for bad in (0, -1, 2.0, True):
            with pytest.raises(ValueError, match="static batch"):
                BatchedMatmulChain(bad, 8, torch.float32)
        with pytest.raises(ValueError, match="n >= 1"):
            BatchedMatmulChain(2, 0, torch.float32)


class TestExpm:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("scale", [0.1, 1.0, 5.0])
    def test_2d_vs_reference_and_scipy(self, scale, backend):
        a = randn((24, 24), int(scale * 10), scale / np.sqrt(24))
        ja, ta = pair(a, "float32")
        want = jexpm(ja)
        got = expm(ta, backend=backend)
        # Pade-13 is 6 products and a solve, then up to ~3 squarings here.
        assert_close(got, want, "float32", n=24, mults=10)
        assert_close(got, scipy.linalg.expm(a.astype(np.float64)), "float32",
                     n=24, mults=10)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_stack_with_per_matrix_scaling(self, backend):
        a = randn((4, 20, 20), 60, 1.0) * \
            np.array([0.01, 0.3, 1.0, 3.0], np.float32)[:, None, None]
        ja, ta = pair(a, "float32")
        want = jexpm(ja)
        got = batched_expm(ta, backend=backend)
        assert_close(got, want, "float32", n=20, mults=12)
        ref = np.stack([scipy.linalg.expm(m.astype(np.float64)) for m in a])
        assert_close(got, ref, "float32", n=20, mults=12)

    def test_reference_chain_interpret(self):
        ja, ta = pair(randn((96, 96), 0, 0.2), "float32")
        want = jexpm(ja, backend="pallas_chain_interpret")
        got = expm(ta, backend="cuda_chain")
        assert_close(got, want, "float32", n=96, mults=10)

    def test_bf16_computes_in_f32_and_casts_once(self):
        ja, ta = pair(randn((16, 16), 61, 0.3), "bfloat16")
        want = jexpm(ja)
        got = expm(ta, backend="cuda_chain")
        assert got.dtype == torch.bfloat16
        assert_close(got, want, "bfloat16", n=16, mults=8)
        # identical to rounding the f32 result of the same (bf16-valued) input
        assert torch.equal(got, expm(ta.float(), backend="cuda_chain")
                           .to(torch.bfloat16))

    def test_f64_computes_in_f64(self):
        a = randn((12, 12), 62, 0.5).astype(np.float64)
        got = expm(torch.from_numpy(a), backend="cuda_chain")
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), scipy.linalg.expm(a),
                                   rtol=1e-10, atol=1e-12)

    def test_zero_is_identity(self):
        for backend in BACKENDS:
            np.testing.assert_allclose(
                expm(torch.zeros(6, 6), backend=backend).numpy(), np.eye(6),
                atol=1e-6)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_batched_mask_no_nan_near_overflow(self, backend):
        """The reference's regression: the per-member mask must be a select
        (``torch.where``), not multiply-masking. The member that finishes
        early still rides the loop to the stack's max s; its wasted extra
        squaring overflows fp32 (e^60 ~ 1.14e26, squared = inf) and
        ``0 * inf = NaN`` would corrupt its already-correct answer."""
        small = 60.0 * np.eye(4, dtype=np.float32)
        big = 100.0 * np.eye(4, dtype=np.float32)
        jb, tb = pair(np.stack([small, big]), "float32")
        out = expm(tb, backend=backend).numpy()
        np.testing.assert_allclose(
            np.diag(out[0]), np.full(4, np.exp(np.float32(60.0))), rtol=1e-5)
        assert np.isfinite(out[0]).all()
        assert not np.isnan(out[1]).any()       # overflow is inf, never NaN
        solo = expm(torch.from_numpy(small), backend=backend).numpy()
        np.testing.assert_array_equal(out[0], solo)
        want = np.asarray(jexpm(jb))
        np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
        np.testing.assert_allclose(out[0], want[0], rtol=1e-5)

    def test_chain_squares_to_the_stacks_max_s(self):
        a = np.stack([np.eye(8, dtype=np.float32) * 0.1,
                      np.eye(8, dtype=np.float32) * 40.0])
        expm(torch.from_numpy(a), backend="cuda_chain")
        # s = ceil(log2(40 / 5.37)) = 3 stacked squarings, one call each
        assert K.launch_counts()["plain_square_whole"] == 3
        assert K.launch_counts()["plain_matmul"] == 0

    def test_max_squarings_clips(self):
        a = torch.eye(4) * 40.0
        expm(a, backend="cuda_chain", max_squarings=1)
        assert K.launch_counts()["plain_square_whole"] == 1

    @pytest.mark.parametrize("shape", [(3, 4), (5,), (2, 3, 4)])
    def test_non_square_raises(self, shape):
        with pytest.raises(ValueError, match="square"):
            expm(torch.zeros(shape))

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_empty_matrix_raises(self, backend):
        with pytest.raises(ValueError, match="n >= 1"):
            expm(torch.zeros(0, 0), backend=backend)

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="unknown matmul backend"):
            expm(torch.eye(4), backend="pallas_fastmm")
