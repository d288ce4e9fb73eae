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
from repro_torch.kernels import attention_kernels as A
from repro_torch.kernels import autotune, error_budget, ops, ref
from repro_torch.kernels import matmul_kernels as K

pytestmark = pytest.mark.gpu

B64 = dict(block_m=64, block_n=64, block_k=32)


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune_torch.json"))
    autotune.clear_memory_cache()
    K.reset_launches()
    A.reset_launches()
    return torch.device("cuda")


def _randn(shape, dtype, device, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape) * shape[-1] ** -0.25
    return torch.from_numpy(a).to(device=device, dtype=dtype)


# Kernel and plain version both accumulate in fp32 (fp64 for fp64) and round
# once, so they differ by the summation order and one unit in the last place
# of the output type at most; the limit is relative to the largest entry.
KERNEL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
               torch.float16: 2e-3, torch.float64: 1e-12}
# K5 is held to the same numbers per query row (each row's largest error over
# that row's largest entry): an attention output's scale varies by row, and
# a limit on the whole output's peak would pass a dropped KV tile. It
# computes float64 inputs in fp32, as the reference does.
ATTN_RTOL = {**KERNEL_RTOL, torch.float64: 1e-4}


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.double() - want.double()).abs().max().item()
    assert err <= KERNEL_RTOL[dtype] * want.double().abs().max().item()


def _attn_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert ref.row_relative_error(got, want) <= ATTN_RTOL[dtype]


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


SIXTEEN_BIT = (torch.bfloat16, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_matmul_kernel_vs_plain(cuda, dtype):
    a = _randn((256, 384), dtype, cuda, 1)
    b = _randn((384, 128), dtype, cuda, 2)
    _close(K.matmul_cuda(a, b, **B64), K.matmul_plain(a, b, **B64), dtype)
    assert K.launch_counts()[K.kernel_name("matmul", dtype)] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("tier,limits", [
    ("square_whole", {}), ("square_panel", dict(smem_limit=0)),
    ("matmul", dict(smem_limit=0, panel_limit=0))])
def test_square_tiers_vs_plain(cuda, tier, limits, dtype):
    a = _randn((3, 128, 128), dtype, cuda, 3)
    got = K.square_cuda(a, **B64, **limits)
    _close(got, K.square_plain(a, **B64, **limits), dtype)
    # one launch for the stack
    assert K.launch_counts()[K.kernel_name(tier, dtype)] == 1


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
    # sent to the whole tier, 1024^2 f32 has no K2 grid whose strips fit
    # a block (512^2 has since K2 stages only its tiles' rows and columns)
    with pytest.raises(ValueError, match="does not fit"):
        K.square_cuda(_randn((1024, 1024), torch.float32, cuda), **B64,
                      smem_limit=1 << 30)
    assert not any(K.launch_counts().values())


def test_out_dtype_other_than_operand_rounds_once(cuda):
    a = _randn((128, 128), torch.bfloat16, cuda)
    wide = K.matmul_cuda(a, a, **B64, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    _close(wide, K.matmul_plain(a, a, **B64, out_dtype=torch.float32),
           torch.float32)


# -- the 16-bit tensor-core K1 / K3 (csrc/gemm_tc.cuh) ----------------------

TC_TILINGS = [pytest.param(t, bk, id=f"{t}x{bk}") for t, bk in K.TC_BLOCKS]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("tile,bk", TC_TILINGS)
def test_tc_matmul_every_tiling(cuda, tile, bk, dtype, out_dtype):
    """Every instantiated (tile, K step), M != N != K, both output types."""
    m, n, k = 2 * tile, 3 * tile, 5 * bk
    a = _randn((m, k), dtype, cuda, 10)
    b = _randn((k, n), dtype, cuda, 11)
    kw = dict(block_m=tile, block_n=tile, block_k=bk, out_dtype=out_dtype)
    got = K.matmul_cuda(a, b, **kw)
    assert got.dtype == (out_dtype or dtype)
    _close(got, K.matmul_plain(a, b, **kw), out_dtype or dtype)
    assert K.launch_counts()["matmul_tc"] == 1
    assert K.launch_counts()["matmul"] == 0


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("tile,bk", TC_TILINGS)
@pytest.mark.parametrize("depth", ["one_stage", "4096"])
def test_tc_matmul_depth(cuda, tile, bk, dtype, depth):
    """K of one ring stage, and K = 4096: many trips round the ring."""
    k = bk if depth == "one_stage" else 4096
    a = _randn((tile, k), dtype, cuda, 12)
    b = _randn((k, 2 * tile), dtype, cuda, 13)
    kw = dict(block_m=tile, block_n=tile, block_k=bk)
    _close(K.matmul_cuda(a, b, **kw), K.matmul_plain(a, b, **kw), dtype)


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("blocks", [(32, 32, 32), (64, 64, 64),
                                    (128, 128, 32)])
@pytest.mark.parametrize("form", ["both", "left", "right"])
def test_tc_matmul_stacked_and_broadcast(cuda, form, blocks, dtype):
    """A stack on both sides, or a 2-D operand shared by the stack on
    either side (stride 0: the tensor map's row coordinate stays put)."""
    t, _, bk = blocks
    a = _randn((3, 2 * t, 4 * bk), dtype, cuda, 14)
    b = _randn((3, 4 * bk, t), dtype, cuda, 15)
    if form == "left":
        b = b[1].contiguous()
    if form == "right":
        a = a[2].contiguous()
    kw = dict(block_m=t, block_n=t, block_k=bk)
    _close(K.matmul_cuda(a, b, **kw), K.matmul_plain(a, b, **kw), dtype)
    assert K.launch_counts()["matmul_tc"] == 1     # one launch for the stack


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("tile,bk", TC_TILINGS)
def test_tc_square_panel_every_tiling(cuda, tile, bk, dtype, out_dtype):
    """K3 on tensor cores, forced into the panel tier, 2-D and stacked."""
    p = {32: 256, 64: 384, 128: 256}[tile]
    kw = dict(block_m=tile, block_n=tile, block_k=bk, smem_limit=0,
              out_dtype=out_dtype)
    for shape in ((p, p), (3, p, p)):
        a = _randn(shape, dtype, cuda, 16)
        got = K.square_cuda(a, **kw)
        assert got.dtype == (out_dtype or dtype)
        _close(got, K.square_plain(a, **kw), out_dtype or dtype)
    assert K.launch_counts()["square_panel_tc"] == 2
    assert K.launch_counts()["square_panel"] == 0


def test_tc_refuses_a_k_step_it_does_not_instantiate(cuda):
    a = _randn((128, 128), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="tensor-core"):
        K.matmul_cuda(a, a, block_m=64, block_n=64, block_k=16)
    with pytest.raises(ValueError, match="tensor-core"):
        K.square_cuda(a, block_m=64, block_n=64, block_k=8, smem_limit=0)
    assert not any(K.launch_counts().values())


def _rel_to_peak(got, want):
    """Largest error over the largest entry of ``want``."""
    want = want.double()
    return ((got.double() - want).abs().max()
            / want.abs().max()).item()


def test_tc_chain_at_1024_bf16(cuda):
    """A^96 at n = 1024 bf16: six K3 squarings and one K1 combine, all on
    the tensor cores. Held, as ``chip_smoke.check_close`` holds it, to the
    budget's elementwise limits and to the bf16 rtol of the largest entry of
    the float64 power (the budget's absolute floor, 0.875 here, is above
    every entry of A^96); and to the ``"torch"`` route at the kernels'
    limit. The check sees the exponent: A^64 misses A^96 by half its peak."""
    a = _power_operand(1024, cuda, 17).to(torch.bfloat16)
    got = matpow_binary(a, 96, backend="cuda_chain")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"square_panel_tc": 6, "matmul_tc": 1}
    assert torch.isfinite(got).all()
    rtol, atol = error_budget(torch.bfloat16, n=1024, mults=7)
    want = torch.linalg.matrix_power(a.double(), 96)
    assert _rel_to_peak(torch.linalg.matrix_power(a.double(), 64), want) \
        > 0.5
    assert torch.allclose(got.double(), want, rtol=rtol, atol=atol)
    assert _rel_to_peak(got, want) <= error_budget(torch.bfloat16)[0]
    via_torch = matpow_binary(a, 96, backend="torch")
    assert _rel_to_peak(got, via_torch) <= KERNEL_RTOL[torch.bfloat16]


# -- K2 on the tensor cores (csrc/gemm_tc.cuh), K2's grid rule in f32 / f64 --

@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("shape", [(192, 192), (256, 256), (32, 128, 128),
                                   (96, 96), (320, 320), (3, 32, 32)])
def test_tc_square_whole_vs_plain(cuda, shape, dtype, out_dtype):
    """The 16-bit K2 at the main path's 192^2 and 256^2, the stacked expm
    shape, sizes that are not a multiple of its 64-wide boxes (zeros past P,
    not the next matrix's rows) and the largest operand of the tier; both
    output types."""
    a = _randn(shape, dtype, cuda, 20)
    kw = dict(block_m=32, block_n=32, block_k=32, out_dtype=out_dtype)
    got = K.square_cuda(a, **kw)
    launch = dict(K.last_launch)
    assert got.dtype == (out_dtype or dtype)
    _close(got, K.square_plain(a, **kw), out_dtype or dtype)
    assert K.launch_counts()["square_whole_tc"] == 1
    assert K.launch_counts()["square_whole"] == 0
    p, batch = shape[-1], (shape[0] if len(shape) == 3 else 1)
    assert (launch["tile"], launch["groups"]) == \
        K.square_whole_grid(p, batch, dtype)
    assert launch["blocks"] == launch["groups"] * batch


def test_tc_square_whole_fills_the_card_at_192(cuda):
    a = _randn((192, 192), torch.bfloat16, cuda, 21)
    K.square_cuda(a, block_m=64, block_n=64, block_k=64)
    assert K.last_launch["kernel"] == "square_whole_tc"
    assert K.last_launch["tile"] == 32 and K.last_launch["blocks"] >= 36


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,tile", [((128, 128), 16), ((3, 128, 128), 16),
                                        ((33, 128, 128), 64),
                                        ((132, 64, 64), 64)])
def test_fma_square_whole_grid_rule(cuda, shape, tile, dtype):
    """f32 K2 on the FMA pipeline at tiles 16 and 64, as its grid rule
    picks them, with its K slices; f64 K2 on the fp64 tensor cores
    (``square_whole_dmma``) on the tile its own rule picks."""
    a = _randn(shape, dtype, cuda, 22)
    kw = dict(block_m=32, block_n=32, block_k=16)
    got = K.square_cuda(a, **kw)
    p, batch = shape[-1], (shape[0] if len(shape) == 3 else 1)
    assert K.last_launch["kernel"] == K.kernel_name("square_whole", dtype)
    assert K.last_launch["tile"] == (
        tile if dtype == torch.float32
        else K.square_whole_grid(p, batch, dtype)[0])
    if dtype == torch.float32:
        assert K.last_launch["slices"] == K.WHOLE_F32[tile][2]
    _close(got, K.square_plain(a, **kw), dtype)


def _f32_whole_grids():
    """(tile, groups, shape) for every f32 K2 tile: one block per tile, a
    few blocks of several tiles each (uneven counts too), single and
    stacked — each grid whose strips fit a block's shared memory."""
    cases = []
    for shape in ((192, 192), (2, 96, 96)):
        p = shape[-1]
        for tile in sorted(K.WHOLE_F32):
            count = (p // tile) ** 2
            for groups in sorted({1, 3, 7, count}):
                if p % tile == 0 and groups <= count and \
                        K.whole_fma_smem_bytes(p, tile, groups) \
                        <= K.SMEM_PER_BLOCK:
                    cases.append(pytest.param(
                        tile, groups, shape, id=f"{tile}-{groups}-{p}-"
                        f"{len(shape)}d"))
    return cases


@pytest.mark.parametrize("out_dtype", [None, torch.float64])
@pytest.mark.parametrize("tile,groups,shape", _f32_whole_grids())
def test_f32_square_whole_every_tile(cuda, monkeypatch, tile, groups, shape,
                                     out_dtype):
    """Every instantiated f32 K2 tile and its K slices, with one block per
    tile and blocks of several tiles each (a block stages the union of its
    tiles' rows and columns in its strips), single and stacked, written as
    f32 and widened after (both ``out_acc`` routes). Partial sums are added
    in another order than one sequential FMA loop: held to 1e-4 of the
    peak, not to equality."""
    monkeypatch.setattr(K, "square_whole_grid",
                        lambda p, batch, dtype: (tile, groups))
    a = _randn(shape, torch.float32, cuda, 62)
    kw = dict(block_m=32, block_n=32, block_k=16, out_dtype=out_dtype)
    got = K.square_cuda(a, **kw)
    assert K.last_launch == dict(
        kernel="square_whole", tile=tile, groups=groups,
        blocks=groups * (shape[0] if len(shape) == 3 else 1),
        slices=K.WHOLE_F32[tile][2])
    assert got.dtype == (out_dtype or torch.float32)
    _close(got, K.square_plain(a, **kw), torch.float32)


@pytest.mark.parametrize("p", [32, 128, 160, 224])
def test_f32_square_whole_on_its_rule(cuda, p):
    """The whole tier's sizes up to its edge (224²) on the grid the rule
    picks."""
    a = _randn((p, p), torch.float32, cuda, 63)
    kw = dict(block_m=32, block_n=32, block_k=16)
    got = K.square_cuda(a, **kw)
    assert K.last_launch["kernel"] == "square_whole"
    assert (K.last_launch["tile"], K.last_launch["groups"]) == \
        K.square_whole_grid(p, 1, torch.float32)
    _close(got, K.square_plain(a, **kw), torch.float32)


# -- K1 f32 and K3 f32 / f64 on the cp.async rings of csrc/gemm.cuh ----------

F32_TILINGS = [pytest.param(t, bk, id=f"{t}x{bk}") for t, bk in
               K.F32_BLOCKS]


@pytest.mark.parametrize("tile,bk", F32_TILINGS)
def test_f32_matmul_every_tiling(cuda, tile, bk):
    """Every instantiated (tile, K step, stages), M != N != K."""
    a = _randn((2 * tile, 5 * bk), torch.float32, cuda, 30)
    b = _randn((5 * bk, 3 * tile), torch.float32, cuda, 31)
    kw = dict(block_m=tile, block_n=tile, block_k=bk)
    _close(K.matmul_cuda(a, b, **kw), K.matmul_plain(a, b, **kw),
           torch.float32)
    assert K.launch_counts()["matmul"] == 1


@pytest.mark.parametrize("tile,bk", F32_TILINGS)
@pytest.mark.parametrize("form", ["both", "left", "right", "deep",
                                  "one_step"])
def test_f32_matmul_stacked_and_deep(cuda, tile, bk, form):
    """A stack on both sides or one 2-D side shared by the stack (stride
    0); K = 4096, many trips round the ring; K of one step, fewer than the
    ring's stages."""
    if form in ("deep", "one_step"):
        k = 4096 if form == "deep" else bk
        a = _randn((tile, k), torch.float32, cuda, 32)
        b = _randn((k, 2 * tile), torch.float32, cuda, 33)
    else:
        a = _randn((3, 2 * tile, 4 * bk), torch.float32, cuda, 34)
        b = _randn((3, 4 * bk, tile), torch.float32, cuda, 35)
        if form == "left":
            b = b[1].contiguous()
        if form == "right":
            a = a[2].contiguous()
    kw = dict(block_m=tile, block_n=tile, block_k=bk)
    _close(K.matmul_cuda(a, b, **kw), K.matmul_plain(a, b, **kw),
           torch.float32)
    assert K.launch_counts()["matmul"] == 1


def test_f32_refuses_a_k_step_it_does_not_instantiate(cuda):
    a = _randn((128, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="FMA"):
        K.matmul_cuda(a, a, block_m=64, block_n=64, block_k=64)
    assert not any(K.launch_counts().values())


def _panel_case(a, kw, dtype):
    got = K.square_cuda(a, **kw)
    launch = dict(K.last_launch)
    _close(got, K.square_plain(a, **kw), dtype)
    p, batch = a.shape[-1], (a.shape[0] if a.ndim == 3 else 1)
    assert launch["kernel"] == K.kernel_name("square_panel", dtype)
    assert (launch["tile"], launch["width"], launch["groups"]) == \
        K.square_panel_grid(p, batch, dtype, kw["block_m"])
    assert launch["blocks"] == launch["groups"] * p // launch["tile"] * batch
    return launch


def test_f32_square_panel_fills_the_card_at_512(cuda):
    """K3 at the main path's 512^2 on the grid ``square_panel_grid`` picks:
    32-row panels, 128 blocks."""
    a = _randn((512, 512), torch.float32, cuda, 36)
    launch = _panel_case(a, B64, torch.float32)
    assert launch["blocks"] >= 128 and launch["tile"] == 32


@pytest.mark.parametrize("shape,tile", [((64, 256, 256), 64),
                                        ((33, 128, 128), 64),
                                        ((3, 288, 288), 32),
                                        ((2, 704, 704), 64)])
def test_f32_square_panel_stacks(cuda, shape, tile):
    """The stacked chain's shape, an odd stack, a size only 32 divides
    (32-wide column tiles) and the largest one of the tier, forced into the
    panel tier."""
    a = _randn(shape, torch.float32, cuda, 37)
    _panel_case(a, dict(block_m=tile, block_n=tile, block_k=16,
                        smem_limit=0), torch.float32)


def test_f32_square_panel_uneven_groups(cuda, monkeypatch):
    """Groups that do not divide the column tiles: the first blocks of a
    panel take one column tile more than the last."""
    monkeypatch.setattr(K, "square_panel_grid",
                        lambda p, batch, dtype, tile: (32, 64, 3))
    a = _randn((2, 512, 512), torch.float32, cuda, 38)
    got = K.square_cuda(a, **B64)
    assert K.last_launch["groups"] == 3
    _close(got, K.square_plain(a, **B64), torch.float32)


@pytest.mark.parametrize("blocks", [(64, 64, 32), (32, 32, 16)])
@pytest.mark.parametrize("shape", [(256, 256), (3, 256, 256)])
def test_f64_square_panel(cuda, shape, blocks):
    """K3 in f64 on the fp64 tensor cores (``square_panel_dmma``), on the
    grid its rule picks: held to 1e-12 of the peak."""
    a = _randn(shape, torch.float64, cuda, 39)
    t, _, bk = blocks
    _panel_case(a, dict(block_m=t, block_n=t, block_k=bk, smem_limit=0),
                torch.float64)


@pytest.mark.parametrize("n,tier", [(1024, "matmul"), (512, "square_panel")])
def test_f32_chain_holds_the_budget(cuda, n, tier):
    """A^96 in f32 through the chain: at n = 1024 every multiply on K1
    (tier limits (1, 1) in the tuning cache: no squaring tier), at n = 512
    six squarings on K3 and the combine on K1; within
    ``error_budget(float32, n, mults=7)`` of the float64 power."""
    if tier == "matmul":
        autotune.record_square_tiers(1, 1, dtype=torch.float32,
                                     backend="cuda")
    a = _power_operand(n, cuda, 40)
    got = matpow_binary(a, 96, backend="cuda_chain")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == ({"matmul": 7} if tier == "matmul"
                      else {"square_panel": 6, "matmul": 1})
    rtol, atol = error_budget(torch.float32, n=n, mults=7)
    want = torch.linalg.matrix_power(a.double(), 96)
    assert torch.allclose(got.double(), want, rtol=rtol, atol=atol)
    assert _rel_to_peak(got, want) <= error_budget(torch.float32)[0]


# -- K1 in f64 on the fp64 tensor cores (csrc/gemm_dmma.cuh) ----------------

DMMA_TILINGS = [pytest.param(t, bk, id=f"{t}x{bk}") for t, bk in
                K.DMMA_BLOCKS]


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("tile,bk", DMMA_TILINGS)
def test_dmma_matmul_every_tiling(cuda, tile, bk, out_dtype):
    """Every instantiated (tile, K step), M != N != K, both output types
    (an f32 output is the f64 result rounded once)."""
    a = _randn((2 * tile, 5 * bk), torch.float64, cuda, 23)
    b = _randn((5 * bk, 3 * tile), torch.float64, cuda, 24)
    kw = dict(block_m=tile, block_n=tile, block_k=bk, out_dtype=out_dtype)
    got = K.matmul_cuda(a, b, **kw)
    assert got.dtype == (out_dtype or torch.float64)
    _close(got, K.matmul_plain(a, b, **kw), out_dtype or torch.float64)
    assert K.launch_counts()["matmul_dmma"] == 1
    assert K.launch_counts()["matmul"] == 0


@pytest.mark.parametrize("tile,bk", DMMA_TILINGS)
@pytest.mark.parametrize("form", ["both", "left", "right", "deep"])
def test_dmma_matmul_stacked_and_deep(cuda, tile, bk, form):
    """A stack on both sides or one 2-D side shared by the stack; and
    K = 4096, many trips round the ring."""
    if form == "deep":
        a = _randn((tile, 4096), torch.float64, cuda, 25)
        b = _randn((4096, 2 * tile), torch.float64, cuda, 26)
    else:
        a = _randn((3, 2 * tile, 4 * bk), torch.float64, cuda, 27)
        b = _randn((3, 4 * bk, tile), torch.float64, cuda, 28)
        if form == "left":
            b = b[1].contiguous()
        if form == "right":
            a = a[2].contiguous()
    kw = dict(block_m=tile, block_n=tile, block_k=bk)
    _close(K.matmul_cuda(a, b, **kw), K.matmul_plain(a, b, **kw),
           torch.float64)
    assert K.launch_counts()["matmul_dmma"] == 1


def test_dmma_refuses_a_pair_it_does_not_instantiate(cuda):
    a = _randn((128, 128), torch.float64, cuda)
    with pytest.raises(ValueError, match="tensor-core"):
        K.matmul_cuda(a, a, block_m=128, block_n=128, block_k=32)
    assert not any(K.launch_counts().values())


def test_dmma_chain_holds_the_f64_budget(cuda):
    """A^96 at n = 512 f64 through the chain (K1 on DMMA for every multiply:
    the panel tier's row panel does not fit at fp64) against the float64
    power and the ``"torch"`` route, under DENSE_BUDGET["float64"]."""
    a = _power_operand(512, cuda, 29).double()
    got = matpow_binary(a, 96, backend="cuda_chain")
    counts = {k: v for k, v in K.launch_counts().items() if v}
    assert counts == {"matmul_dmma": 7}
    rtol, atol = error_budget(torch.float64, n=512, mults=7)
    want = torch.linalg.matrix_power(a, 96)
    assert torch.allclose(got, want, rtol=rtol, atol=atol)
    assert torch.allclose(got, matpow_binary(a, 96, backend="torch"),
                          rtol=rtol, atol=atol)


# -- K2 and K3 in f64 on the fp64 tensor cores (csrc/gemm_dmma.cuh) ----------
#
# Held to their plain versions at 1e-12 of the peak, not bit for bit: the K
# slices of a block add their partial sums in slice order, another order
# than the plain version's in-order sum over k.

@pytest.mark.parametrize("shape", [(128, 128), (160, 160), (96, 96),
                                   (32, 128, 128), (33, 128, 128),
                                   (3, 32, 32)])
def test_dmma_square_whole_vs_plain(cuda, shape):
    """The main path's 128^2, the largest operand of the f64 whole tier,
    the stacks of the smoke and a size with one box row per K step."""
    a = _randn(shape, torch.float64, cuda, 60)
    kw = dict(block_m=32, block_n=32, block_k=16)
    got = K.square_cuda(a, **kw)
    launch = dict(K.last_launch)
    _close(got, K.square_plain(a, **kw), torch.float64)
    p, batch = shape[-1], (shape[0] if len(shape) == 3 else 1)
    assert launch["kernel"] == "square_whole_dmma"
    assert (launch["tile"], launch["groups"]) == \
        K.square_whole_grid(p, batch, torch.float64)
    assert K.launch_counts()["square_whole_dmma"] == 1
    assert K.launch_counts()["square_whole"] == 0


@pytest.mark.parametrize("groups", [1, 3, 7])
@pytest.mark.parametrize("tile", K.WHOLE_DMMA_TILES)
def test_dmma_square_whole_every_tile(cuda, monkeypatch, tile, groups):
    """Every instantiated K2 tile, with blocks of several tiles each
    (uneven counts too): a block stages the union of its tiles' rows and
    columns."""
    monkeypatch.setattr(K, "square_whole_grid",
                        lambda p, batch, dtype: (tile, groups))
    a = _randn((2, 128, 128), torch.float64, cuda, 61)
    kw = dict(block_m=64, block_n=64, block_k=32)
    got = K.square_cuda(a, **kw)
    assert K.last_launch["tile"] == tile
    _close(got, K.square_plain(a, **kw), torch.float64)


@pytest.mark.parametrize("shape,blocks", [
    ((256, 256), (64, 64, 32)), ((64, 256, 256), (64, 64, 32)),
    ((33, 128, 128), (64, 64, 16)), ((3, 288, 288), (32, 32, 16)),
    ((192, 192), (64, 64, 32)), ((384, 384), (64, 64, 32)),
    ((2, 320, 320), (64, 64, 32))])
def test_dmma_square_panel_vs_plain(cuda, shape, blocks):
    """The smoke's K3 shapes, and the f64 panel tier's first and last
    sizes, forced into the panel tier, on the grids the rule picks."""
    a = _randn(shape, torch.float64, cuda, 62)
    t, _, bk = blocks
    _panel_case(a, dict(block_m=t, block_n=t, block_k=bk, smem_limit=0),
                torch.float64)
    assert K.launch_counts()["square_panel_dmma"] == 1
    assert K.launch_counts()["square_panel"] == 0


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("height,width", list(K.DMMA_PANELS))
def test_dmma_square_panel_every_pair(cuda, monkeypatch, height, width,
                                      groups):
    """Every instantiated (height, width) pair, a block over one column
    tile or several (and uneven shares of them), 2-D and stacked, on its
    64-deep ring (256^2, 192^2) and its 32-deep one (288^2)."""
    monkeypatch.setattr(K, "square_panel_grid",
                        lambda p, batch, dtype, tile: (height, width,
                                                       groups))
    shapes = [(256, 256), (3, 192, 192)]
    if 288 % width == 0:
        shapes.append((2, 288, 288))
    for shape in shapes:
        a = _randn(shape, torch.float64, cuda, 63)
        tile = 64 if shape[-1] % 64 == 0 else 32
        kw = dict(block_m=tile, block_n=tile, block_k=16, smem_limit=0)
        got = K.square_cuda(a, **kw)
        assert (K.last_launch["tile"], K.last_launch["width"]) == \
            (height, width)
        _close(got, K.square_plain(a, **kw), torch.float64)


def test_dmma_squares_refuse_a_pair_they_do_not_instantiate(cuda,
                                                           monkeypatch):
    """A tile or pair outside the tables reaches the launcher, which
    refuses it (-1), or finds no ring: the wrapper raises, counts nothing
    and falls back to nothing."""
    a = _randn((192, 192), torch.float64, cuda, 64)
    monkeypatch.setattr(K, "square_panel_grid",
                        lambda p, batch, dtype, tile: (16, 64, 1))
    with pytest.raises(ValueError, match="instantiated"):
        K.square_cuda(a, **B64, smem_limit=0)
    monkeypatch.setattr(K, "square_panel_grid",
                        lambda p, batch, dtype, tile: (48, 32, 1))
    with pytest.raises(KeyError, match="no fp64 K3 ring of height 48"):
        K.square_cuda(a, **B64, smem_limit=0)
    monkeypatch.setattr(K, "square_whole_grid",
                        lambda p, batch, dtype: (48, 1))
    with pytest.raises(ValueError, match="instantiated"):
        K.square_cuda(a[:96, :96].contiguous(), block_m=32, block_n=32,
                      block_k=16)
    assert not any(K.launch_counts().values())


@pytest.mark.parametrize("n,counts", [
    (128, {"square_whole_dmma": 6, "matmul_dmma": 1}),
    (200, {"square_panel_dmma": 6, "matmul_dmma": 1}),
    (256, {"square_panel_dmma": 6, "matmul_dmma": 1}),
    (320, {"square_panel_dmma": 6, "matmul_dmma": 1})])
def test_dmma_squaring_chain_holds_the_f64_budget(cuda, n, counts):
    """A^96 in f64 through the chain, its squarings on the fp64 K2 / K3:
    within ``error_budget(float64, n, mults=7)`` of the float64 power and of
    the ``"torch"`` route; the operand unaltered."""
    a = _power_operand(n, cuda, 65).double()
    keep = a.clone()
    got = matpow_binary(a, 96, backend="cuda_chain")
    assert {k: v for k, v in K.launch_counts().items() if v} == counts
    assert torch.equal(a, keep)
    rtol, atol = error_budget(torch.float64, n=n, mults=7)
    want = torch.linalg.matrix_power(a, 96)
    assert _rel_to_peak(torch.linalg.matrix_power(a, 64), want) > 0.5
    assert torch.allclose(got, want, rtol=rtol, atol=atol)
    assert _rel_to_peak(got, want) <= error_budget(torch.float64)[0]
    assert torch.allclose(got, matpow_binary(a, 96, backend="torch"),
                          rtol=rtol, atol=atol)


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


def _qkv(lead, sq, skv, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((*lead, s, d)))
                 .to(device=device, dtype=dtype) for s in (sq, skv, skv))


def _attn_launched(dtype) -> dict:
    """The launches one K5 call on ``dtype`` makes: its kernel once, and the
    combine once when it split the KV bands (``last_launch["splits"]``)."""
    return {**{name: 0 for name in A.LAUNCHES}, A.kernel_name(dtype): 1,
            "attn_combine": int(A.last_launch["splits"] > 1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
@pytest.mark.parametrize("cfg", [
    dict(lead=(2,), sq=256, skv=256, d=64, causal=True, window=None),
    dict(lead=(2,), sq=128, skv=512, d=128, causal=True, window=None),
    dict(lead=(2, 3), sq=256, skv=256, d=128, causal=True, window=64),
    dict(lead=(1,), sq=256, skv=256, d=64, causal=False, window=None),
    dict(lead=(2,), sq=192, skv=192, d=48, causal=True, window=None),
    dict(lead=(1,), sq=64, skv=64, d=256, causal=False, window=32),
])
def test_flash_attention_kernel_vs_plain(cuda, cfg, dtype):
    q, k, v = _qkv(cfg["lead"], cfg["sq"], cfg["skv"], cfg["d"], dtype, cuda)
    kw = dict(causal=cfg["causal"], window=cfg["window"])
    got = A.flash_attention(q, k, v, **kw)
    assert A.launch_counts() == _attn_launched(dtype)     # one K5 launch
    want = A.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype
    _attn_close(got, want, dtype)


@pytest.mark.parametrize("blocks", [(64, 32), (64, 64), (64, 128), (128, 32),
                                    (128, 64), (128, 128), (111, 37),
                                    (32, 16)])
def test_flash_attention_every_tile_and_ragged_blocks(cuda, blocks):
    sq = skv = 333 if blocks == (111, 37) else 256
    q, k, v = _qkv((2,), sq, skv, 64, torch.float32, cuda, 1)
    got = A.flash_attention(q, k, v, block_q=blocks[0], block_k=blocks[1])
    _attn_close(got, A.flash_attention_plain(q, k, v), torch.float32)
    assert A.last_launch["block_q"] == blocks[0]
    assert A.last_launch["tile"] == A.kernel_tile(*blocks, 64)
    assert A.last_launch["kernel"] == "flash_attention"


def test_flash_attention_row_with_no_key_is_zero(cuda):
    """Sq > Skv, causal: query rows 0..127 sit before every key."""
    q, k, v = _qkv((1,), 256, 128, 64, torch.float32, cuda, 2)
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :128], torch.zeros_like(got[:, :128]))
    _attn_close(got, A.flash_attention_plain(q, k, v, causal=True),
                torch.float32)


def test_flash_attention_uses_the_cached_blocks(cuda):
    autotune.record(512, 512, 128, (64, 32), kernel="attention",
                    dtype=torch.bfloat16, backend="cuda")
    q, k, v = _qkv((4,), 512, 512, 128, torch.bfloat16, cuda, 3)
    ops.attention(q, k, v)
    assert (A.last_launch["block_q"], A.last_launch["block_k"]) == (64, 32)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1,), 256, 256, 128, torch.float32, cuda, 4)
    with pytest.raises(ValueError, match="not divisible"):
        A.flash_attention(q, k, v, block_q=96, block_k=64)
    with pytest.raises(ValueError, match="instantiated"):
        A.flash_attention(q, k, v, block_q=128, block_k=128)
    with pytest.raises(TypeError, match="dtype"):
        A.flash_attention(q.int(), k.int(), v.int(), block_q=64, block_k=64)
    assert A.launch_counts()["flash_attention"] == 0


FMA_ATTN_TILES = [pytest.param(d, t, id=f"d{d}-{t[0]}x{t[1]}")
                  for d, ts in A.ATTN_TILES["fma"].items() for t in ts]


@pytest.mark.parametrize("grid", ["split", "whole"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,tile", FMA_ATTN_TILES)
def test_fma_attention_every_tile(cuda, d, tile, dtype, grid):
    """Every FMA tile on its ring, causal, four KV steps (eight half steps:
    two trips round a ring of three slots, four of two): with 2 leading
    slices the grid splits the bands and the combine merges them; with 140
    it fills the card and does not."""
    lead = (2,) if grid == "split" else (140,)
    q, k, v = _qkv(lead, 4 * tile[0], 4 * tile[1], d, dtype, cuda, 26)
    got = A.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    assert A.launch_counts() == _attn_launched(dtype)
    assert A.last_launch["tile"] == tile
    assert (A.last_launch["splits"] > 1) == (grid == "split")
    assert got.dtype == dtype
    _attn_close(got, A.flash_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sq,skv,d,blocks,window", [
    (333, 333, 64, (111, 37), None),     # ragged: keys past bk are masked
    (333, 333, 128, (111, 37), 50),
    (256, 256, 128, (32, 16), None),     # a block far below its tile
    (192, 192, 48, (64, 64), None),      # head width padded to 64
    (96, 96, 256, (48, 48), 20),
    (256, 128, 64, (64, 64), None),      # Sq > Skv: rows before every key
    (256, 256, 64, (64, 64), 0),         # an empty window: every row 0
])
def test_fma_attention_ragged_blocks_and_windows(cuda, sq, skv, d, blocks,
                                                 window, dtype):
    for lead in ((3,), (3, 50)):
        q, k, v = _qkv(lead, sq, skv, d, dtype, cuda, 27)
        kw = dict(causal=True, window=window)
        got = A.flash_attention(q, k, v, block_q=blocks[0],
                                block_k=blocks[1], **kw)
        assert A.last_launch["tile"] == A.kernel_tile(*blocks, d, dtype)
        assert A.last_launch["kernel"] == "flash_attention"
        _attn_close(got, A.flash_attention_plain(q, k, v, **kw), dtype)
        if window == 0:
            assert torch.equal(got, torch.zeros_like(got))
        if sq > skv:
            assert torch.equal(got[..., :sq - skv, :],
                               torch.zeros_like(got[..., :sq - skv, :]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lead", [(1,), (140,)])
def test_fma_attention_row_with_no_key_is_zero(cuda, lead, dtype):
    """Sq > Skv, causal: query rows 0..127 sit before every key, with a
    split grid (1 slice) and a whole one (140)."""
    q, k, v = _qkv(lead, 256, 128, 64, dtype, cuda, 28)
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :128], torch.zeros_like(got[:, :128]))
    _attn_close(got, A.flash_attention_plain(q, k, v, causal=True), dtype)


# -- K5 on the tensor cores (csrc/attention_tc.cuh) and split-KV -------------

TC_ATTN_TILES = [pytest.param(d, t, id=f"d{d}-{t[0]}x{t[1]}")
                 for d, ts in A.ATTN_TILES["tc"].items() for t in ts]


@pytest.mark.parametrize("grid", ["split", "whole"])
@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d,tile", TC_ATTN_TILES)
def test_tc_attention_every_tile(cuda, d, tile, dtype, grid):
    """Every 16-bit tile, causal, several KV steps (two trips round the
    ring at least): with 2 leading slices the grid splits the bands and
    the combine merges them; with 140 it fills the card and does not."""
    lead = (2,) if grid == "split" else (140,)
    q, k, v = _qkv(lead, 4 * tile[0], 4 * tile[1], d, dtype, cuda, 20)
    got = A.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    assert A.launch_counts() == _attn_launched(dtype)
    assert A.last_launch["tile"] == tile
    assert (A.last_launch["splits"] > 1) == (grid == "split")
    _attn_close(got, A.flash_attention_plain(q, k, v), dtype)


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("sq,skv,d,blocks,window", [
    (333, 333, 64, (111, 37), None),     # ragged: keys past bk are masked
    (333, 333, 128, (111, 37), 50),
    (256, 256, 128, (32, 16), None),     # a block far below its tile
    (192, 192, 48, (64, 64), None),      # head width padded to 64
    (96, 96, 256, (48, 48), 20),
    (256, 256, 64, (64, 64), 0),         # an empty window: every row 0
])
def test_tc_attention_ragged_blocks_and_windows(cuda, sq, skv, d, blocks,
                                                window, dtype):
    for lead in ((3,), (3, 50)):
        q, k, v = _qkv(lead, sq, skv, d, dtype, cuda, 21)
        kw = dict(causal=True, window=window)
        got = A.flash_attention(q, k, v, block_q=blocks[0],
                                block_k=blocks[1], **kw)
        assert A.last_launch["tile"] == A.kernel_tile(*blocks, d, dtype)
        _attn_close(got, A.flash_attention_plain(q, k, v, **kw), dtype)
        if window == 0:
            assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.parametrize("lead", [(1,), (140,)])
def test_tc_attention_row_with_no_key_is_zero(cuda, lead):
    """bf16, Sq > Skv, causal: query rows 0..127 sit before every key."""
    q, k, v = _qkv(lead, 256, 128, 64, torch.bfloat16, cuda, 22)
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :128], torch.zeros_like(got[:, :128]))
    _attn_close(got, A.flash_attention_plain(q, k, v, causal=True),
                torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.float64])
@pytest.mark.parametrize("sq,window", [(1, None), (128, None), (128, 1000),
                                       (1, 300)])
def test_split_kv_decode(cuda, sq, window, dtype):
    """Decode shapes, 16 heads: 1 or 128 queries against 4096 keys, one
    query block per head, so the bands split. With window 1000 the window's
    edge moves across a split border from row to row, and the first split
    of the band sees no key for the last rows."""
    q, k, v = _qkv((16,), sq, 4096, 128, dtype, cuda, 23)
    kw = dict(causal=True, window=window)
    got = A.flash_attention(q, k, v, **kw)
    splits = A.last_launch["splits"]
    assert splits > 1
    assert A.launch_counts() == _attn_launched(dtype)
    if window == 1000:
        bk = A.last_launch["block_k"]
        first, band = A.kv_range(0, sq, sq, 4096, bk, True, window)
        chunk = -(-band // splits)
        borders = {first + z * chunk * bk for z in range(1, splits)}
        edges = {4096 - sq + r - window + 1 for r in range(sq)}
        assert borders & edges                      # an edge on a border
        # split 0 ends before the first key the last row sees
        assert first + chunk * bk <= 4096 - window
    _attn_close(got, A.flash_attention_plain(q, k, v, **kw), dtype)
    whole = A.flash_attention_split_plain(
        q, k, v, block_q=A.last_launch["block_q"],
        block_k=A.last_launch["block_k"], splits=splits, **kw)
    _attn_close(got, whole, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_combine_kernel_vs_plain(cuda, dtype):
    rng = np.random.default_rng(24)
    part_o = torch.from_numpy(rng.standard_normal((5, 300, 128))
                              .astype(np.float32)).to(cuda)
    part_ml = torch.from_numpy(rng.standard_normal((5, 300, 2))
                               .astype(np.float32)).abs().to(cuda)
    part_ml[1:, :7, 0] = -float("inf")   # rows only split 0 saw
    part_ml[:, 7:9, 0] = -float("inf")   # rows no split saw
    part_ml[:, 7:9, 1] = 0.0
    part_o[:, 7:9] = 0.0
    out = torch.empty(300, 128, dtype=dtype, device=cuda)
    A.attn_combine(part_o, part_ml, out)
    assert A.launch_counts()["attn_combine"] == 1
    want = A.attn_combine_plain(part_o, part_ml, dtype)
    # the combine computes in fp32 for every output type, as all of K5 does
    _attn_close(out, want, dtype)
    assert torch.equal(out[7:9], torch.zeros_like(out[7:9]))


def test_routes_by_dtype(cuda):
    """bf16 reaches the tensor-core kernel and f32 the FMA kernel; the
    combine launches exactly when the bands split."""
    for dtype, lead in ((torch.bfloat16, (2,)), (torch.bfloat16, (200,)),
                        (torch.float32, (2,)), (torch.float32, (200,))):
        A.reset_launches()
        q, k, v = _qkv(lead, 512, 512, 128, dtype, cuda, 25)
        ops.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert A.last_launch["kernel"] == A.kernel_name(dtype) == (
            "flash_attention_tc" if dtype == torch.bfloat16
            else "flash_attention")
        assert (A.last_launch["splits"] > 1) == (lead == (2,))
        assert A.launch_counts() == _attn_launched(dtype)


def test_tc_attention_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1,), 256, 256, 256, torch.bfloat16, cuda, 26)
    with pytest.raises(ValueError, match="instantiated"):
        A.flash_attention(q, k, v, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="not divisible"):
        A.flash_attention(q, k, v, block_q=96, block_k=64)
    part_o = torch.zeros(2, 8, 512, device=cuda)
    with pytest.raises(ValueError, match="width 512"):
        A.attn_combine(part_o, torch.zeros(2, 8, 2, device=cuda),
                       torch.empty(8, 512, device=cuda))
    assert not any(A.launch_counts().values())


class TestServingEngine:
    """The serving engine (``repro_torch.serve.matfn``) on the card: chain
    buckets launch the hand-written kernels, the stream rule of the
    module's docstring holds (the caller's stream, the engine's copy), the
    stream count does not change a bit, and a failing bucket reaches its
    futures as ``BucketExecutionError``."""

    #: (dtype, n) of chain buckets and the squaring kernel each must launch
    #: (the combines of p = 7 launch K1 of the same family).
    CHAIN_CASES = [(torch.float32, 192, "square_whole"),
                   (torch.float32, 512, "square_panel"),
                   (torch.bfloat16, 256, "square_whole_tc"),
                   (torch.bfloat16, 1024, "square_panel_tc"),
                   (torch.float64, 128, "square_whole_dmma"),
                   (torch.float64, 256, "square_panel_dmma")]

    @staticmethod
    def _engine(**kw):
        from repro_torch.serve import MatFnEngine
        return MatFnEngine(device="cuda", **kw)

    @pytest.mark.parametrize("dtype,n,square", CHAIN_CASES,
                             ids=lambda v: str(v).removeprefix("torch."))
    def test_chain_buckets_launch_the_kernels(self, cuda, dtype, n, square):
        eng = self._engine()
        mats = [_power_operand(n, cuda, seed).to(dtype) for seed in range(3)]
        for m in mats:
            eng.submit("matpow", m, power=7)
        K.reset_launches()
        res = eng.flush()
        counts = K.launch_counts()
        assert eng.stats["routes"]["chain"] == 1
        assert counts[square] == 2                   # p = 7: two squarings
        assert counts[K.kernel_name("matmul", dtype)] == 2   # two combines
        assert not any(v for k, v in counts.items() if k.startswith("plain"))
        rtol, atol = error_budget(dtype, n=n, mults=4)
        for m, r in zip(mats, res):
            want = torch.linalg.matrix_power(m.double(), 7)
            assert torch.allclose(r.double(), want, rtol=rtol, atol=atol)

    def test_caller_stream_is_waited_for(self, cuda):
        """The operand is written on the caller's stream behind a long
        kernel; the engine's worker must wait for it, and a result read on
        another stream must be complete."""
        a = _power_operand(256, cuda, 3)
        want = torch.linalg.matrix_power(a.double(), 7)
        side, reader = torch.cuda.Stream(), torch.cuda.Stream()
        with self._engine() as eng:
            with torch.cuda.stream(side):
                x = torch.zeros_like(a)
                torch.cuda._sleep(200_000_000)       # ~0.1 s on the card
                x.copy_(a)
                fut = eng.submit("matpow", x, power=7)
            eng.kick()
            got = fut.result(timeout=60)
        with torch.cuda.stream(reader):
            copy = got.clone()
        reader.synchronize()
        rtol, atol = error_budget(torch.float32, n=256, mults=4)
        assert torch.allclose(copy.double(), want, rtol=rtol, atol=atol)

    @pytest.mark.parametrize("daemon", [False, True])
    def test_writes_after_submit_do_not_change_the_answer(self, cuda,
                                                          daemon):
        a = _power_operand(192, cuda, 4)
        want = torch.linalg.matrix_power(a.double(), 7)
        eng = self._engine()
        if daemon:
            eng.start()
        fut = eng.submit("matpow", a, power=7)
        a.zero_()
        if daemon:
            eng.kick()
            got = fut.result(timeout=60)
            eng.close()
        else:
            (got,) = eng.flush()
        rtol, atol = error_budget(torch.float32, n=192, mults=4)
        assert torch.allclose(got.double(), want, rtol=rtol, atol=atol)

    def test_stream_count_does_not_change_a_bit_on_the_chain(self, cuda):
        from repro_torch.serve import ExecutionStreams, ManualClock
        mats = [(_power_operand(n, cuda, 10 + i).to(dt), p)
                for i, (dt, n, p) in enumerate(
                    [(torch.float32, 192, 7), (torch.float32, 512, 96),
                     (torch.bfloat16, 256, 7), (torch.float64, 128, 96)] * 4)]
        outs = []
        for streams in (ExecutionStreams(streams=1), None):
            with self._engine(streams=streams, clock=ManualClock(),
                              max_delay_ms=1e6) as eng:
                futs = [eng.submit("matpow", m, power=p) for m, p in mats]
                eng.kick()
                outs.append([f.result(timeout=120) for f in futs])
                assert eng.stats["routes"]["chain"] == 4
        assert all(torch.equal(x, y) for x, y in zip(*outs))

    def test_torch_route_same_bits_with_a_fixed_cublas_workspace(self, cuda):
        """cuBLAS is deterministic across streams only with a fixed
        workspace, so this runs in a subprocess that sets
        CUBLAS_WORKSPACE_CONFIG before CUDA starts."""
        import os
        import subprocess
        import sys
        from pathlib import Path
        code = (
            "import torch\n"
            "from repro_torch.serve import (ExecutionStreams, ManualClock,\n"
            "                               MatFnEngine)\n"
            "g = torch.Generator().manual_seed(0)\n"
            "mats = [(torch.randn(n, n, generator=g) / n ** 0.5).cuda()\n"
            "        for n in (16, 32, 64) * 6]\n"
            "outs = []\n"
            "for streams in (ExecutionStreams(streams=1), None):\n"
            "    with MatFnEngine(device='cuda', streams=streams,\n"
            "                     clock=ManualClock(), max_delay_ms=1e6) as e:\n"
            "        futs = [e.submit('matpow', m, power=96) for m in mats]\n"
            "        futs += [e.submit('expm', m) for m in mats]\n"
            "        e.kick()\n"
            "        outs.append([f.result(timeout=120) for f in futs])\n"
            "        assert e.stats['routes']['torch'] == 6, e.stats\n"
            "assert all(torch.equal(x, y) for x, y in zip(*outs))\n"
            "print('same bits')\n")
        src = Path(__file__).resolve().parent.parent / "src"
        env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
               "PYTHONPATH": str(src)}
        done = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr[-2000:]
        assert "same bits" in done.stdout

    def test_a_failing_bucket_reaches_its_futures(self, cuda):
        from repro_torch.serve import BucketExecutionError, ManualClock
        # One bucket, flushed by the kick alone: on the system clock a
        # deadline could split the three requests into two buckets, each
        # retried once.
        eng = self._engine(retries=1, clock=ManualClock(), max_delay_ms=1e6)

        def failing(op, n, dtype, power, operands):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        eng._run_chunk = failing
        with eng:
            futs = [eng.submit("matpow", _power_operand(192, cuda, s),
                               power=7) for s in range(3)]
            eng.kick()
            for f in futs:
                exc = f.exception(timeout=60)
                assert isinstance(exc, BucketExecutionError)
                assert "illegal memory access" in str(exc)
            assert eng.stats()["retries"] == 1
            assert eng.stats()["lanes"]["bulk"]["flushed"] == 0
