"""The CUDA kernels on a GPU: wrappers' hygiene and kernel-vs-plain parity.

Every test here needs a CUDA device and ``nvcc`` (the kernels build at first
use) and is marked ``gpu``; without a device they skip. Run them on a
machine with a GPU:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` covers the same ground end to end; these are the
unit-sized versions, plus the refusals only the kernel route has.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import batched_matpow, matpow_binary
from repro_torch.kernels import error_budget, ops
from repro_torch.kernels import matmul_kernels as K

pytestmark = pytest.mark.gpu

B64 = dict(block_m=64, block_n=64, block_k=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    K.reset_launches()
    return torch.device("cuda")


def _randn(shape, dtype, device, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * shape[-1] ** -0.25
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# Kernel and plain version both accumulate in fp32 (fp64 for fp64) and round
# once, so they differ by the summation order and one unit in the last place
# of the output type at most; the limit is relative to the largest entry.
KERNEL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
               torch.float16: 2e-3, torch.float64: 1e-12}


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= KERNEL_RTOL[dtype] * want.double().abs().max().item()


def _power_operand(n, device, seed):
    """Row-stochastic with distinct powers: (1 - 1/32) P + S / 32, P the
    permutation matrix of one random n-cycle (a dense random stochastic
    matrix alone has S^4 == S^96 to rounding and hides the exponent)."""
    rng = np.random.default_rng(seed)
    s = rng.random((n, n)) + 0.05
    m = s / s.sum(-1, keepdims=True) / 32
    cycle = rng.permutation(n)
    m[cycle, np.roll(cycle, -1)] += 31 / 32
    return torch.from_numpy(m).to(device, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_matmul_kernel_vs_plain(cuda, dtype):
    a = _randn((256, 384), dtype, cuda, 1)
    b = _randn((384, 128), dtype, cuda, 2)
    _close(K.matmul_cuda(a, b, **B64), K.matmul_plain(a, b, **B64), dtype)
    assert K.launch_counts()["matmul"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("tier,limits", [
    ("square_whole", {}), ("square_panel", dict(smem_limit=0)),
    ("matmul", dict(smem_limit=0, panel_limit=0))])
def test_square_tiers_vs_plain(cuda, tier, limits, dtype):
    a = _randn((3, 128, 128), dtype, cuda, 3)
    got = K.square_cuda(a, **B64, **limits)
    _close(got, K.square_plain(a, **B64, **limits), dtype)
    assert K.launch_counts()[tier] == 1           # one launch for the stack


def test_out_must_not_alias_the_operand(cuda):
    a = _randn((128, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="alias"):
        K.square_cuda(a, **B64, out=a)
    with pytest.raises(ValueError, match="alias"):
        K.matmul_cuda(a, a, **B64, out=a)
    out = torch.empty_like(a)
    assert K.square_cuda(a, **B64, out=out) is out
    _close(out, K.square_plain(a, **B64), torch.float32)


def test_kernel_route_refuses_what_it_does_not_take(cuda):
    a = _randn((128, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.matmul_cuda(a.t(), a, **B64)
    with pytest.raises(ValueError, match="square output tiles"):
        K.matmul_cuda(a, a, block_m=128, block_n=64, block_k=32)
    with pytest.raises(ValueError, match="square output tiles"):
        K.matmul_cuda(a, a, block_m=16, block_n=16, block_k=16)
    with pytest.raises(TypeError, match="dtype"):
        K.matmul_cuda(a.int(), a.int(), **B64)
    with pytest.raises(ValueError, match="does not fit"):
        K.square_cuda(_randn((512, 512), torch.float32, cuda), **B64,
                      smem_limit=1 << 30)
    assert not any(K.launch_counts().values())


def test_out_dtype_other_than_operand_rounds_once(cuda):
    a = _randn((128, 128), torch.bfloat16, cuda)
    wide = K.matmul_cuda(a, a, **B64, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    _close(wide, K.matmul_plain(a, a, **B64, out_dtype=torch.float32),
           torch.float32)


def test_chain_launches_and_leaves_operand_alone(cuda):
    a = _power_operand(200, cuda, 4)
    keep = a.clone()
    got = matpow_binary(a, 96, backend="cuda_chain")
    counts = K.launch_counts()
    assert counts["square_panel"] == 6 and counts["matmul"] == 1
    assert not any(v for k, v in counts.items() if k.startswith("plain_"))
    assert torch.equal(a, keep)
    rtol, atol = error_budget(torch.float32, n=200, mults=7)
    want = torch.linalg.matrix_power(a.double(), 96)
    assert torch.allclose(got.double(), want, rtol=rtol, atol=atol)
    lost_combine = torch.linalg.matrix_power(a.double(), 64)
    assert not torch.allclose(lost_combine, want, rtol=rtol, atol=atol)


def test_stacked_chain_is_one_launch_per_multiply(cuda):
    a = _randn((16, 96, 96), torch.float32, cuda, 5) * 0.3
    got = batched_matpow(a, 7, backend="cuda_chain")
    counts = K.launch_counts()
    assert counts["square_whole"] == 2 and counts["matmul"] == 2
    want = torch.linalg.matrix_power(a.double(), 7)
    rtol, atol = error_budget(torch.float32, n=96, mults=4)
    assert torch.allclose(got.double(), want, rtol=rtol, atol=atol)


def test_ops_matmul_pads_and_strips_on_the_gpu(cuda):
    a = _randn((33, 257), torch.float32, cuda, 6)
    b = _randn((257, 129), torch.float32, cuda, 7)
    _close(ops.matmul(a, b), (a.double() @ b.double()).float(), torch.float32)
    assert K.launch_counts()["matmul"] == 1
