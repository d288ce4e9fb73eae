"""Port kernels' plain versions vs the reference's Pallas kernels.

The reference runs ``matmul_pallas`` / ``square_pallas`` in interpret mode
(as ``tests/test_kernels.py`` does); the port runs ``matmul_plain`` /
``square_plain`` — what its wrappers take for a CPU tensor — on the same
numpy inputs. Tolerance: the port's ``error_budget(dtype, n=K)``. The CUDA
kernels themselves cannot run without a GPU; ``chip_smoke.py`` holds each
against its plain version on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.matmul import matmul_pallas, square_pallas
from repro_torch.kernels import matmul_kernels as K

from _torch_parity import (TORCH, as_f64, assert_close, cuh_constants,
                           cuh_struct, pair, randn)

B128 = dict(block_m=128, block_n=128, block_k=128)

# how each framework is forced into a squaring tier at a small size
TIER_LIMITS = {
    "whole": dict(ref={}, port=dict(smem_limit=1 << 30, panel_limit=1 << 31)),
    "panel": dict(ref=dict(vmem_limit=1, panel_limit=1 << 30),
                  port=dict(smem_limit=1, panel_limit=1 << 30)),
    "two_operand": dict(ref=dict(vmem_limit=1, panel_limit=1),
                        port=dict(smem_limit=1, panel_limit=1)),
}


@pytest.fixture(autouse=True)
def _fresh_counters():
    K.reset_launches()
    yield


class TestMatmulParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mkn", [
        (128, 128, 128), (256, 128, 384), (512, 512, 512),
        (384, 640, 256), (128, 1024, 128),
    ])
    def test_block_divisible(self, mkn, dtype):
        m, k, n = mkn
        ja, ta = pair(randn((m, k), 0, k ** -0.25), dtype)
        jb, tb = pair(randn((k, n), 1, k ** -0.25), dtype)
        want = matmul_pallas(ja, jb, interpret=True, **B128)
        got = K.matmul_cuda(ta, tb, **B128)
        assert got.dtype == TORCH[dtype] and got.shape == (m, n)
        assert_close(got, want, dtype, n=k)

    def test_deep_k_accumulates_in_fp32(self):
        """K >> block_k with bf16 operands: one rounding, at the store."""
        ja, ta = pair(randn((128, 2048), 6, 2048 ** -0.25), "bfloat16")
        jb, tb = pair(randn((2048, 128), 7, 2048 ** -0.25), "bfloat16")
        want = matmul_pallas(ja, jb, interpret=True, **B128)
        assert_close(K.matmul_cuda(ta, tb, **B128), want, "bfloat16", n=2048)

    def test_out_dtype_widens_once(self):
        ja, ta = pair(randn((128, 128), 8, 0.3), "bfloat16")
        want = matmul_pallas(ja, ja, interpret=True, out_dtype=np.float32,
                             **B128)
        got = K.matmul_cuda(ta, ta, out_dtype=torch.float32, **B128)
        assert got.dtype == torch.float32
        assert_close(got, want, "float32", n=128)

    @pytest.mark.parametrize("dtype", ["float16", "float64"])
    def test_dtypes_the_reference_does_not_sweep(self, dtype):
        """f16 and f64 have no reference sweep on the CPU (x64 is off in
        JAX): hold the plain version to a float64 numpy product."""
        a = randn((64, 96), 9, 96 ** -0.25)
        b = randn((96, 32), 10, 96 ** -0.25)
        ta = torch.from_numpy(a).to(TORCH[dtype])
        tb = torch.from_numpy(b).to(TORCH[dtype])
        got = K.matmul_cuda(ta, tb, block_m=32, block_n=32, block_k=16)
        assert got.dtype == TORCH[dtype]
        assert_close(got, as_f64(ta) @ as_f64(tb), dtype, n=96)

    @pytest.mark.parametrize("form", ["both", "left", "right"])
    def test_stacked_forms(self, form):
        a = randn((3, 64, 96), 11, 0.3)
        b = randn((3, 96, 32), 12, 0.3)
        if form == "left":
            b = b[0]
        if form == "right":
            a = a[0]
        got = K.matmul_cuda(torch.from_numpy(a), torch.from_numpy(b),
                            block_m=32, block_n=32, block_k=32)
        assert_close(got, np.matmul(a.astype(np.float64), b), "float32", n=96)
        assert K.LAUNCHES["plain_matmul"] == 1   # one call for the stack

    def test_out_buffer_receives_result(self):
        a = torch.from_numpy(randn((64, 64), 13, 0.3))
        out = torch.empty(64, 64)
        res = K.matmul_cuda(a, a, block_m=32, block_n=32, block_k=32, out=out)
        assert res is out
        np.testing.assert_allclose(out.numpy(), (a @ a).numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_non_divisible_raises_like_the_reference(self):
        ja, ta = pair(randn((100, 128), 14), "float32")
        jb, tb = pair(randn((128, 128), 15), "float32")
        with pytest.raises(ValueError, match="not divisible by blocks") as ref:
            matmul_pallas(ja, jb, interpret=True, **B128)
        with pytest.raises(ValueError, match="not divisible by blocks") as port:
            K.matmul_cuda(ta, tb, **B128)
        assert str(ref.value) == str(port.value)

    @pytest.mark.parametrize("shapes", [((4, 5), (6, 4)), ((4,), (4, 4)),
                                        ((2, 4, 4), (3, 4, 4))])
    def test_bad_shapes(self, shapes):
        a, b = (torch.zeros(s) for s in shapes)
        with pytest.raises(ValueError, match="bad matmul shapes"):
            K.matmul_cuda(a, b, block_m=1, block_n=1, block_k=1)


class TestSquareParity:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("p", [128, 256])
    @pytest.mark.parametrize("tier", ["whole", "panel", "two_operand"])
    def test_each_tier(self, tier, p, dtype):
        ja, ta = pair(randn((p, p), p, p ** -0.25), dtype)
        want = square_pallas(ja, interpret=True, **B128,
                             **TIER_LIMITS[tier]["ref"])
        got = K.square_cuda(ta, **B128, **TIER_LIMITS[tier]["port"])
        assert_close(got, want, dtype, n=p)
        counted = "plain_matmul" if tier == "two_operand" \
            else "plain_square_" + tier
        assert K.launch_counts()[counted] == 1
        assert sum(K.launch_counts().values()) == 1

    def test_tiers_agree_with_each_other(self):
        a = torch.from_numpy(randn((256, 256), 10, 0.1))
        outs = [K.square_cuda(a, **B128, **TIER_LIMITS[t]["port"])
                for t in TIER_LIMITS]
        for got in outs[1:]:
            np.testing.assert_allclose(got.numpy(), outs[0].numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_stacked_square_is_one_call(self):
        a = randn((4, 64, 64), 16, 0.2)
        got = K.square_cuda(torch.from_numpy(a), block_m=32, block_n=32,
                            block_k=32)
        assert_close(got, np.matmul(a.astype(np.float64), a), "float32", n=64)
        assert K.launch_counts()["plain_square_whole"] == 1

    def test_non_divisible_raises_like_the_reference(self):
        ja, ta = pair(randn((192, 192), 17), "float32")
        with pytest.raises(ValueError, match="not divisible by blocks") as ref:
            square_pallas(ja, interpret=True, **B128)
        with pytest.raises(ValueError, match="not divisible by blocks") as port:
            K.square_cuda(ta, **B128)
        assert str(ref.value) == str(port.value)

    def test_rejects_nonsquare(self):
        with pytest.raises(ValueError, match="square"):
            K.square_cuda(torch.ones(128, 256), **B128)


class TestSquareTierPolicy:
    def test_boundaries_are_inclusive(self):
        assert K.square_tier(K.SQUARE_SMEM_LIMIT) == "whole"
        assert K.square_tier(K.SQUARE_SMEM_LIMIT + 1) == "panel"
        assert K.square_tier(K.SQUARE_PANEL_LIMIT) == "panel"
        assert K.square_tier(K.SQUARE_PANEL_LIMIT + 1) == "two_operand"

    def test_custom_thresholds(self):
        assert K.square_tier(100, smem_limit=10, panel_limit=50) == \
            "two_operand"
        assert K.square_tier(30, smem_limit=10, panel_limit=50) == "panel"
        assert K.square_tier(10, smem_limit=10, panel_limit=50) == "whole"

    def test_default_limits_are_the_cards_own(self):
        """Derived from a block's shared memory and the L2 cache — not the
        reference's limits for another memory hierarchy."""
        assert K.SQUARE_SMEM_LIMIT == K.SMEM_PER_BLOCK == 232_448
        assert K.SQUARE_PANEL_LIMIT == K.L2_BYTES // 2
        # a 192^2 fp32 operand is staged whole, 512^2 takes the panel
        # kernel, and the full-width 4096^2 operand streams through K1
        assert K.square_tier(192 * 192 * 4) == "whole"
        assert K.square_tier(512 * 512 * 4) == "panel"
        assert K.square_tier(4096 * 4096 * 4) == "two_operand"
        assert K.square_tier(4096 * 4096 * 2) == "two_operand"

    def test_panel_footprint_gates_the_panel_tier(self):
        # 1024^2 fp32 qualifies for the panel tier by operand bytes, but a
        # 128-row panel is 512 KB — more than a block's shared memory.
        assert K.panel_smem_footprint(1024, 128, 128, itemsize=4) \
            > K.SMEM_PER_BLOCK
        assert K.panel_smem_footprint(512, 64, 64, itemsize=4) \
            <= K.SMEM_PER_BLOCK
        a = torch.from_numpy(randn((1024, 1024), 18, 0.03))
        K.square_cuda(a, block_m=128, block_n=128, block_k=32)
        assert K.launch_counts()["plain_matmul"] == 1      # demoted to K1
        assert K.launch_counts()["plain_square_panel"] == 0
        K.square_cuda(a[:512, :512].contiguous(), block_m=64, block_n=64,
                      block_k=32)
        assert K.launch_counts()["plain_square_panel"] == 1


GEMM_TC = Path(K.__file__).parent / "csrc" / "gemm_tc.cuh"
TC_PAIRS = [pytest.param(t, bk, id=f"{t}x{bk}") for t, bk in K.TC_BLOCKS]


def _cuh_constants(src=None) -> dict:
    """The namespace-level ``constexpr int k...`` constants of gemm_tc.cuh."""
    return cuh_constants(src or GEMM_TC.read_text())


def _cuh_struct(name, src=None, **params) -> dict:
    """The members of gemm_tc.cuh's ``struct name`` (``cuh_struct``)."""
    return cuh_struct(src or GEMM_TC.read_text(), name, **params)


class TestTensorCoreContract:
    """What the Python side knows of csrc/gemm_tc.cuh: the (tile, K step)
    table and the shared memory each launcher asks for. A pair the picker
    could choose but the library lacks would only show as a -1 from the
    launcher on the card; a footprint that disagreed with the launcher's
    request would pass a tiling the card refuses."""

    def test_tc_table_is_the_kernels(self):
        lines = re.findall(r"^\s*REPRO_TC_TILE\((\d+), (\d+)\)\s*$",
                           GEMM_TC.read_text(), flags=re.M)
        in_cuda = sorted(tuple(int(x) for x in line) for line in lines)
        assert in_cuda == sorted(K.TC_BLOCKS) and len(in_cuda) == 5

    def test_layout_constants_are_the_kernels(self):
        consts = _cuh_constants()
        assert consts["kAlign"] == K.TC_ALIGN == 1024
        assert consts["kRingBudget"] == K.TC_RING_BUDGET == 232_448 // 2
        assert consts["kPanelStages"] == K.TC_PANEL_STAGES == 4
        assert consts["kMmaPad"] == K.TC_MMA_PAD == 8
        assert consts["kBarrier"] == K.TC_BARRIER == 8

    @pytest.mark.parametrize("tile,bk", TC_PAIRS)
    def test_pairs_are_instantiated_tiles_and_k16_steps(self, tile, bk):
        assert tile in K.KERNEL_TILES and bk % 16 == 0
        assert bk in (32, 64)       # wgmma K steps; tile 32's is one of them

    @pytest.mark.parametrize("tile,bk", TC_PAIRS)
    def test_k1_footprint_is_the_stage_formula(self, tile, bk):
        """What ``smem_footprint`` says K1 asks for is what the ``.cuh``'s
        ``Ring`` / ``MmaTiles`` formulas, evaluated as written, give."""
        got = K.smem_footprint((tile, tile, bk), itemsize=2)
        if tile == 32:
            assert got == _cuh_struct("MmaTiles", BK=bk)["BYTES"]
        else:
            ring = _cuh_struct("Ring", TILE=tile, BK=bk)
            assert ring["STAGES"] == (3 if (tile, bk) == (128, 64) else 4)
            assert got == ring["BYTES"]
        assert got == K.tc_smem_bytes(tile, bk)
        assert got <= K.SMEM_PER_BLOCK // 2 <= K.SMEM_PER_BLOCK

    @pytest.mark.parametrize("p", [256, 512, 1024])
    @pytest.mark.parametrize("tile,bk", TC_PAIRS)
    def test_k3_footprint_is_the_stage_formula(self, tile, bk, p):
        got = K.panel_smem_footprint(p, tile, tile, itemsize=2, block_k=bk)
        if tile == 32:
            want = _cuh_struct("MmaTiles", BK=bk, P=p)["bytes"]
        else:
            want = _cuh_struct("PanelRing", TILE=tile, BK=bk, P=p)["bytes"]
        assert got == want == K.tc_smem_bytes(tile, bk, p)
        # the main path's 1024^2 bf16 squaring fits at tile 64, not at 128
        assert (got <= K.SMEM_PER_BLOCK) == (p < 1024 or tile < 128)

    def test_the_formula_reader_sees_a_changed_formula(self):
        """The C++ formulas are read from the source, not restated: a ring
        whose barriers were dropped evaluates to a different size."""
        src = GEMM_TC.read_text().replace(
            "STAGES * (STAGE + 2 * kBarrier);", "STAGES * STAGE;", 1)
        assert _cuh_struct("Ring", src, TILE=128, BK=64)["BYTES"] \
            != K.tc_smem_bytes(128, 64)

    @pytest.mark.parametrize("blocks", [(64, 64, 16), (128, 128, 16),
                                        (32, 32, 8), (64, 64, 128),
                                        (128, 64, 64)])
    def test_the_tc_launch_refuses_pairs_it_lacks(self, blocks):
        with pytest.raises(ValueError, match="tensor-core"):
            K._kernel_tile(*blocks, "matmul_cuda", table=K.TC_BLOCKS)
        assert K._kernel_tile(64, 64, 64, "matmul_cuda",
                              table=K.TC_BLOCKS) == 64

    @pytest.mark.parametrize("op,dtype,name", [
        ("matmul", torch.float32, "matmul"),
        ("matmul", torch.float64, "matmul_dmma"),
        ("matmul", torch.bfloat16, "matmul_tc"),
        ("matmul", torch.float16, "matmul_tc"),
        ("square_whole", torch.bfloat16, "square_whole_tc"),
        ("square_whole", torch.float16, "square_whole_tc"),
        ("square_whole", torch.float32, "square_whole"),
        ("square_whole", torch.float64, "square_whole_dmma"),
        ("square_panel", torch.float32, "square_panel"),
        ("square_panel", torch.float64, "square_panel_dmma"),
        ("square_panel", torch.bfloat16, "square_panel_tc"),
        ("square_panel", torch.float16, "square_panel_tc")])
    def test_kernel_name_is_the_counter_a_launch_goes_to(self, op, dtype,
                                                         name):
        assert K.kernel_name(op, dtype) == name and name in K.KERNELS

    def test_kernel_name_refuses_an_op_without_a_kernel(self):
        with pytest.raises(ValueError, match="no kernel"):
            K.kernel_name("square_two_operand", torch.float32)

    def test_a_tier_is_demoted_when_the_16_bit_panel_busts_shared_memory(
            self):
        assert K._resolve_tier(1408, 2, 64, 64, 64, K.SQUARE_SMEM_LIMIT,
                               K.SQUARE_PANEL_LIMIT) == "panel"
        assert K._resolve_tier(1536, 2, 128, 128, 64, K.SQUARE_SMEM_LIMIT,
                               K.SQUARE_PANEL_LIMIT) == "two_operand"


GEMM_DMMA = Path(K.__file__).parent / "csrc" / "gemm_dmma.cuh"
WHOLE_TC_SIZES = [32, 64, 96, 128, 192, 256, 288, 320]


def _fma_whole_model(p, batch, tile, groups):
    """The f32 K2 grid rule's modelled ns of a grid, restated: waves of the
    blocks an SM holds at once (shared memory, threads) times the block's
    fixed cost and its staged bytes, plus the SM's FMAs at the rate its
    thread tile feeds."""
    rows, cols, slices = K.WHOLE_F32[tile]
    threads = slices * tile * tile // (rows * cols)
    resident = max(1, min(
        K.SMEM_PER_SM // (K.whole_fma_smem_bytes(p, tile, groups)
                          + K.SMEM_PER_RESIDENT_BLOCK),
        K.THREADS_PER_SM // threads))
    per_row = p // tile
    mine = range(0, per_row * per_row, groups)
    r = len({t // per_row for t in mine}) * tile
    c = len({t % per_row for t in mine}) * tile
    per_sm = -(-groups * batch // K.SM_COUNT)
    rate = K.FMA_SM_GFLOPS * min(1.0, rows * cols / (4 * (rows + cols)))
    return (-(-per_sm // resident) * (K.FMA_WHOLE_BLOCK_NS + (r * p + p * c
                                                               - r * c) * 4
                                      / K.FMA_WHOLE_BLOCK_GBPS)
            + per_sm * len(mine) * 2 * tile * tile * p / rate)


class TestWholeOperandGrid:
    """K2 picks its own output tile and grid (``square_whole_grid``), the
    same function on the kernel route and in the plain version's
    bookkeeping (``last_launch``): enough blocks to fill the card where the
    output allows, whatever the chain's tile."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    def test_192_uses_at_least_36_blocks(self, dtype):
        """The 16-bit K2: 36 blocks of one 32-wide tile; the f32 K2 (since
        it stages only the rows and columns of A its tiles read, in strips
        that let five blocks share an SM): 144 blocks of one 16-wide
        tile."""
        want = (16, 144) if dtype == torch.float32 else (32, 36)
        tile, groups = K.square_whole_grid(192, 1, dtype)
        assert (tile, groups) == want
        a = torch.from_numpy(randn((192, 192), 40, 0.2)).to(dtype)
        K.square_cuda(a, block_m=64, block_n=64, block_k=64)
        assert K.last_launch["kernel"] == "plain_square_whole"
        assert K.last_launch["tile"] == want[0]
        assert K.last_launch["blocks"] >= 36

    def test_the_tile_leaves_the_least_output_on_the_busiest_sm(self):
        # one matrix: the smallest tile, a block per tile
        assert K.square_whole_grid(256, 1, torch.bfloat16) == (32, 64)
        # f64 (the DMMA K2) and f32 (the FMA K2): 16-wide tiles, so each of
        # 64 blocks stages only the rows and columns of A its tile reads
        assert K.square_whole_grid(128, 1, torch.float64) == (16, 64)
        assert K.square_whole_grid(128, 1, torch.float32) == (16, 64)
        # a stack of 32: 128 blocks of one 64-wide tile, not 160 blocks of
        # four 32-wide ones (two waves)
        assert K.square_whole_grid(128, 32, torch.float32) == (64, 4)
        assert K.square_whole_grid(128, 32, torch.bfloat16) == (64, 4)
        # a tie goes to the larger tile
        assert K.square_whole_grid(128, 33, torch.float32) == (64, 4)
        # a stack that fills the card alone: one block a matrix (the f32 K2
        # has no 128-wide tile)
        assert K.square_whole_grid(128, 132, torch.float32) == (64, 1)
        # the tensor-core K2 has no 128-wide tile
        assert K.square_whole_grid(128, 132, torch.bfloat16) == (64, 1)

    @pytest.mark.parametrize("p", [32, 96, 160, 224])
    def test_sizes_that_only_32_divides(self, p):
        """f32 takes 16-wide tiles there, a block each (at 224², 196
        blocks: four or five share an SM, all in one wave)."""
        tile, groups = K.square_whole_grid(p, 1, torch.float32)
        assert (tile, groups) == (16, (p // 16) ** 2)
        assert K.square_whole_grid(p, 1, torch.bfloat16) == (
            32, min((p // 32) ** 2, K.SM_COUNT))

    @pytest.mark.parametrize("batch", [1, 2, 7, 64, 500])
    @pytest.mark.parametrize("p", WHOLE_TC_SIZES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_invariants(self, p, batch, dtype):
        tile, groups = K.square_whole_grid(p, batch, dtype)
        if dtype == torch.float32:
            # the least modelled time over every tile and group count
            assert tile in K.WHOLE_F32 and p % tile == 0
            assert 1 <= groups <= (p // tile) ** 2
            grids = [(t, g) for t in K.WHOLE_F32
                     if p % t == 0 and p // t <= K.WHOLE_F32_MAX_PER_ROW
                     for g in range(1, (p // t) ** 2 + 1)]
            fit = [(t, g) for t, g in grids if K.whole_fma_smem_bytes(
                p, t, g) <= K.SMEM_PER_BLOCK]
            best = min((_fma_whole_model(p, batch, t, g), g * batch, -t)
                       for t, g in fit or grids)
            assert K.whole_fma_smem_bytes(p, tile, groups) \
                <= K.SMEM_PER_BLOCK or not fit
            assert best == (_fma_whole_model(p, batch, tile, groups),
                            groups * batch, -tile)
            return
        assert tile in K.WHOLE_TC_TILES and p % tile == 0
        assert groups == K._groups((p // tile) ** 2, batch)
        assert 1 <= groups <= (p // tile) ** 2
        # while the 32-wide tiles fit one wave, a block per tile is the
        # least any SM can compute, and the smallest tile gives it
        if batch * (p // 32) ** 2 <= K.SM_COUNT:
            assert tile == 32 and groups == (p // 32) ** 2

    def test_no_tile_divides_raises(self):
        with pytest.raises(ValueError, match="divides"):
            K.square_whole_grid(40, 1, torch.float32)
        # the f32 K2 takes at most 32 tiles a side
        with pytest.raises(ValueError, match="divides"):
            K.square_whole_grid(16 * 33, 1, torch.float32)
        with pytest.raises(ValueError, match="divides"):
            K.square_whole_grid(48, 1, torch.bfloat16)

    def test_stacked_plain_route_records_the_grid(self):
        a = torch.from_numpy(randn((32, 128, 128), 41, 0.2))
        K.square_cuda(a, block_m=64, block_n=64, block_k=16)
        assert K.last_launch == dict(kernel="plain_square_whole", tile=64,
                                     blocks=4 * 32, groups=4, slices=4)

    def test_16_bit_plain_route_records_its_own_grid(self):
        """The 16-bit K2's grid is ``groups`` blocks per matrix of the
        stack, on its own tile whatever the chain's tile."""
        a = torch.from_numpy(randn((3, 96, 96), 42, 0.2)).to(torch.bfloat16)
        K.square_cuda(a, block_m=32, block_n=32, block_k=32)
        assert K.last_launch == dict(kernel="plain_square_whole", tile=32,
                                     blocks=9 * 3, groups=9)

    def test_plain_k1_and_k3_record_their_grids(self):
        a = torch.from_numpy(randn((256, 256), 43, 0.2))
        K.matmul_cuda(a, a, block_m=64, block_n=64, block_k=32)
        assert K.last_launch == dict(kernel="plain_matmul", tile=64,
                                     blocks=16)
        K.square_cuda(a, block_m=64, block_n=64, block_k=32, smem_limit=0)
        # K3 takes 32-row panels of 32 x 64 output tiles, 4 blocks a panel
        assert K.last_launch == dict(kernel="plain_square_panel", tile=32,
                                     width=64, blocks=8 * 4, groups=4)


class TestWholeFma:
    """What the Python side knows of the f32 K2 of csrc/gemm.cuh: its table
    of tiles, thread tiles and K slices, the shared memory its launcher asks
    for (``WholeFma`` evaluated as written), the f32 whole tier's edge that
    follows, and the slices a launch records."""

    def test_table_is_the_kernels(self):
        lines = re.findall(
            r"^\s*REPRO_WHOLE_F32\((\d+), (\d+), (\d+), (\d+)\)\s*$",
            GEMM.read_text(), flags=re.M)
        assert {int(t): (int(r), int(c), int(ks))
                for t, r, c, ks in lines} == K.WHOLE_F32
        assert len(lines) == len(K.WHOLE_F32)

    @pytest.mark.parametrize("tile", sorted(K.WHOLE_F32))
    def test_thread_tiles_and_slices(self, tile):
        """Every slice is 4 x 8 or 8 x 8 outputs a thread over the whole
        tile, whole warps or quarter warps of them, and the block's threads
        are the slices' (128 or 256)."""
        rows, cols, slices = K.WHOLE_F32[tile]
        w = cuh_struct(GEMM.read_text(), "WholeFma", TILE=tile, R=rows,
                       C=cols, KS=slices)
        assert w["LY"] * rows == tile and w["LX"] * cols == tile
        assert rows * cols >= 32 and cols % 4 == 0
        assert w["SLICE"] % 8 == 0 and w["THREADS"] in (128, 256)
        assert w["THREADS"] == slices * tile * tile // (rows * cols)
        assert w["RED"] == slices * tile * tile * 4

    @pytest.mark.parametrize("per_row,groups,strips", [
        (12, 144, (1, 1)), (12, 72, (2, 1)), (12, 5, (12, 12)),
        (12, 1, (12, 12)), (2, 4, (1, 1)), (2, 3, (2, 2)), (14, 98, (2, 1)),
        (4, 6, (3, 2))])
    def test_strips(self, per_row, groups, strips):
        """A block's tile rows and columns, the most over the grid's blocks
        (block b takes tiles b, b + groups, ...)."""
        assert K.whole_strips(per_row, groups) == strips
        nr = max(len({t // per_row for t in range(b, per_row ** 2, groups)})
                 for b in range(min(groups, per_row ** 2)))
        assert nr == strips[0]

    @pytest.mark.parametrize("groups", [1, 2, 3, 36, 144])
    @pytest.mark.parametrize("p", [32, 64, 128, 192, 224])
    @pytest.mark.parametrize("tile", sorted(K.WHOLE_F32))
    def test_footprint_is_the_strip_formula(self, tile, p, groups):
        rows, cols, slices = K.WHOLE_F32[tile]
        if p % tile or groups > (p // tile) ** 2:
            return
        nr, nc = K.whole_strips(p // tile, groups)
        want = cuh_struct(GEMM.read_text(), "WholeFma", TILE=tile, R=rows,
                          C=cols, KS=slices, P=p, NR=nr, NC=nc)["bytes"]
        assert K.whole_fma_smem_bytes(p, tile, groups) == want
        assert K.whole_smem_bytes("square_whole", p, tile, groups) == want

    def test_a_forced_operand_past_the_strips_is_refused(self):
        """Sent to the whole tier (``smem_limit`` raised), 512² f32 runs on
        one-tile blocks; at 1024² no grid's strips fit a block, and the
        kernel route refuses the call before launching."""
        assert K.whole_fma_smem_bytes(512, *K.square_whole_grid(
            512, 1, torch.float32)) <= K.SMEM_PER_BLOCK
        tile, groups = K.square_whole_grid(1024, 1, torch.float32)
        assert K.whole_fma_smem_bytes(1024, tile, groups) > K.SMEM_PER_BLOCK
        assert K.whole_smem_bytes("square_whole", 1024, tile, groups) \
            > K.SMEM_PER_BLOCK

    def test_the_whole_tier_edge(self):
        """The f32 whole tier ends at 224² as before (the tier policy: the
        operand within a block's shared memory); K2 itself no longer holds
        all of A, so at 224² its blocks, one 16-wide tile each, ask for
        48,896 B, and five share an SM. A block that owned every tile
        would need both strips whole and does not fit: the rule never
        picks it."""
        assert K.square_tier(224 * 224 * 4) == "whole"
        assert K.square_tier(256 * 256 * 4) == "panel"
        assert K.whole_fma_smem_bytes(224, 16, 196) == \
            (16 * 228 + 224 * 20) * 4 + 16384 == 48_896
        assert K.whole_fma_smem_bytes(224, 16, 1) > K.SMEM_PER_BLOCK
        assert K._resolve_tier(224, 4, 32, 32, 16, K.SQUARE_SMEM_LIMIT,
                               K.SQUARE_PANEL_LIMIT) == "whole"

    def test_the_formula_reader_sees_a_changed_formula(self):
        src = GEMM.read_text().replace("(size_t)NR * TILE * (P + kPad)",
                                       "(size_t)NR * TILE * P", 1)
        assert cuh_struct(src, "WholeFma", TILE=16, R=4, C=8, KS=16,
                          P=192, NR=1, NC=1)["bytes"] \
            != K.whole_fma_smem_bytes(192, 16, 144)

    @pytest.mark.parametrize("p,batch,grid", [
        (128, 1, (16, 64)), (192, 1, (16, 144)), (224, 1, (16, 196)),
        (160, 1, (16, 100)), (128, 32, (64, 4)), (128, 33, (64, 4)),
        (128, 64, (64, 2)), (192, 7, (16, 72))])
    def test_grid(self, p, batch, grid):
        """A single operand takes 16-wide tiles, one a block (each stages a
        16-row and a 16-column strip of A, and up to five blocks share an
        SM); a stack that fills the card takes 64-wide ones on 8 x 8 thread
        tiles."""
        assert K.square_whole_grid(p, batch, torch.float32) == grid

    @pytest.mark.parametrize("shape,launch", [
        ((192, 192), dict(tile=16, blocks=144, groups=144, slices=16)),
        ((3, 96, 96), dict(tile=16, blocks=3 * 36, groups=36, slices=16)),
        ((32, 128, 128), dict(tile=64, blocks=128, groups=4, slices=4))])
    def test_plain_route_records_tile_grid_and_slices(self, shape, launch):
        a = torch.from_numpy(randn(shape, 44, 0.2))
        got = K.square_cuda(a, block_m=32, block_n=32, block_k=16)
        assert K.last_launch == dict(kernel="plain_square_whole", **launch)
        assert torch.equal(got, K.square_plain(a, block_m=32, block_n=32,
                                               block_k=16))


class TestNewKernelTables:
    """What the Python side knows of the 16-bit K2 (gemm_tc.cuh) and the
    fp64 K1 (gemm_dmma.cuh): their instantiation tables and the shared
    memory each launcher asks for, evaluated from the C++ as written."""

    def test_whole_tc_table_is_the_kernels(self):
        lines = re.findall(r"^\s*REPRO_WHOLE_TC\((\d+)\)\s*$",
                           GEMM_TC.read_text(), flags=re.M)
        assert tuple(int(t) for t in lines) == K.WHOLE_TC_TILES
        consts = _cuh_constants()
        assert consts["kWholeBox"] == K.WHOLE_TC_BOX == 64
        assert consts["kWholeRed"] == K.WHOLE_TC_RED == 16384

    @pytest.mark.parametrize("p", WHOLE_TC_SIZES)
    def test_whole_tc_footprint_is_the_box_formula(self, p):
        want = _cuh_struct("WholeBoxes", BOX=K.WHOLE_TC_BOX, P=p)["bytes"]
        assert K.whole_tc_smem_bytes(p) == want
        # every operand of the 16-bit whole tier fits: P <= 320
        assert want <= K.SMEM_PER_BLOCK

    def test_whole_tc_launch_refuses_an_operand_past_shared_memory(self):
        assert K.whole_tc_smem_bytes(352) > K.SMEM_PER_BLOCK

    def test_dmma_table_is_the_kernels(self):
        lines = re.findall(
            r"^\s*REPRO_DMMA_TILE\((\d+), (\d+), (\d+)\)\s*$",
            GEMM_DMMA.read_text(), flags=re.M)
        in_cuda = {(int(t), int(bk)): int(st) for t, bk, st in lines}
        assert in_cuda == K.DMMA_STAGES and len(in_cuda) == 3
        assert K.DMMA_BLOCKS == tuple(K.DMMA_STAGES)

    def test_dmma_constants_are_the_kernels(self):
        assert cuh_constants(GEMM_DMMA.read_text())["kPad"] == K.DMMA_PAD == 4

    @pytest.mark.parametrize("tile,bk", K.DMMA_BLOCKS)
    def test_dmma_footprint_is_the_ring_formula(self, tile, bk):
        ring = cuh_struct(GEMM_DMMA.read_text(), "DmmaRing", TILE=tile, BK=bk,
                          STAGES=K.DMMA_STAGES[(tile, bk)])
        assert K.dmma_smem_bytes(tile, bk) == ring["BYTES"] == \
            K.smem_footprint((tile, tile, bk), itemsize=8)
        assert ring["BYTES"] <= K.SMEM_PER_BLOCK
        # ops.pick_blocks takes only rings within its budget: at least the
        # pair it picks for each tile fits it
        assert min(K.dmma_smem_bytes(t, b) for t, b in K.DMMA_BLOCKS
                   if t == tile) <= K.SMEM_PER_BLOCK // 2

    def test_the_dmma_formula_reader_sees_a_changed_formula(self):
        src = GEMM_DMMA.read_text().replace(
            "LDA = BK + kPad;", "LDA = BK;", 1)
        assert cuh_struct(src, "DmmaRing", TILE=64, BK=32, STAGES=2)[
            "BYTES"] != K.dmma_smem_bytes(64, 32)

    @pytest.mark.parametrize("tile,bk", K.DMMA_BLOCKS)
    def test_dmma_pairs_are_fma_k2_k3_pairs_too(self, tile, bk):
        """A chain's blocks serve the f64 K1 and K2 / K3 alike: every K1
        pair is one the squaring wrapper takes (K2 and K3 then pick their
        own tiles)."""
        assert tile in K.KERNEL_TILES and bk % 8 == 0 and tile % bk == 0
        assert K._kernel_tile(tile, tile, bk, "square_cuda") == tile

    @pytest.mark.parametrize("blocks", [(128, 128, 16), (32, 32, 8),
                                        (64, 64, 64), (128, 64, 16)])
    def test_the_dmma_launch_refuses_pairs_it_lacks(self, blocks):
        with pytest.raises(ValueError, match="tensor-core"):
            K._kernel_tile(*blocks, "matmul_cuda", table=K.DMMA_BLOCKS)


GEMM = Path(K.__file__).parent / "csrc" / "gemm.cuh"
F32_PAIRS = [pytest.param(t, bk, id=f"{t}x{bk}") for t, bk in K.F32_BLOCKS]
PANEL_SIZES = [256, 288, 320, 384, 512, 640, 768, 832]


class TestFmaContract:
    """What the Python side knows of csrc/gemm.cuh's f32 K1 and K3 (and of
    the f64 K3 of csrc/gemm_dmma.cuh that took over its f64 cases): their
    instantiation tables and the shared memory each launcher asks for,
    evaluated from the C++ as written (a footprint that disagreed with the
    launcher's request would pass a tiling the card refuses)."""

    def test_f32_table_is_the_kernels(self):
        lines = re.findall(
            r"^\s*REPRO_F32_TILE\((\d+), (\d+), (\d+)\)\s*$",
            GEMM.read_text(), flags=re.M)
        in_cuda = {(int(t), int(bk)): int(st) for t, bk, st in lines}
        assert in_cuda == K.F32_STAGES
        assert K.F32_BLOCKS == tuple(K.F32_STAGES)
        assert {t for t, _ in in_cuda} == set(K.KERNEL_TILES)

    def test_panel_table_and_constants_are_the_kernels(self):
        lines = re.findall(r"^\s*REPRO_FMA_PANEL\((\d+), (\d+)\)\s*$",
                           GEMM.read_text(), flags=re.M)
        assert tuple((int(h), int(w)) for h, w in lines) == K.FMA_PANELS
        consts = cuh_constants(GEMM.read_text())
        assert consts["kPad"] == K.SMEM_PAD == 4
        assert consts["kPanelBK"] == K.FMA_PANEL_BK
        assert consts["kPanelStages"] == K.FMA_PANEL_STAGES
        assert consts["kThreads"] == K.FMA_THREADS == 256

    @pytest.mark.parametrize("tile,bk", F32_PAIRS)
    def test_k1_footprint_is_the_ring_formula(self, tile, bk):
        ring = cuh_struct(GEMM.read_text(), "FmaRing", TILE=tile, BK=bk,
                          STAGES=K.F32_STAGES[(tile, bk)])
        assert K.fma_smem_bytes(tile, bk) == ring["BYTES"] == \
            K.smem_footprint((tile, tile, bk))
        assert ring["LDA"] == bk + K.SMEM_PAD
        # every ring lets two blocks share an SM
        assert 2 * (ring["BYTES"] + K.SMEM_PER_RESIDENT_BLOCK) <= K.SMEM_PER_SM

    @pytest.mark.parametrize("itemsize", [4, 8])
    @pytest.mark.parametrize("p", PANEL_SIZES)
    @pytest.mark.parametrize("height", [32, 64])
    def test_k3_footprint_is_the_panel_formula(self, height, p, itemsize):
        """f32: the FMA K3's ``FmaPanel``; f64: the DMMA K3's
        ``DmmaPanel`` at the ring of that height it launches on."""
        if itemsize == 8:
            width, bk, stages = K.dmma_panel_ring(p, height)
            want = cuh_struct(GEMM_DMMA.read_text(), "DmmaPanel", H=height,
                              W=width, BK=bk, STAGES=stages, P=p)["bytes"]
            got = K.dmma_panel_smem_bytes(p, height)
        else:
            want = cuh_struct(GEMM.read_text(), "FmaPanel", H=height,
                              W=K.panel_width(p), P=p)["bytes"]
            got = K.fma_panel_smem_bytes(p, height)
        assert got == want == K.panel_smem_footprint(p, height, height,
                                                      itemsize)

    def test_the_fma_formula_reader_sees_a_changed_formula(self):
        """The C++ formulas are read from the source, not restated: a ring
        without the A pad, a panel without its row pad, evaluate to other
        sizes."""
        src = GEMM.read_text().replace("LDA = BK + kPad;", "LDA = BK;", 1)
        assert cuh_struct(src, "FmaRing", TILE=128, BK=32, STAGES=3)[
            "BYTES"] != K.fma_smem_bytes(128, 32)
        src = GEMM.read_text().replace("(P + kPad) * 4", "P * 4", 1)
        assert cuh_struct(src, "FmaPanel", H=64, W=64, P=512)[
            "bytes"] != K.fma_panel_smem_bytes(512, 64)

    @pytest.mark.parametrize("blocks", [(128, 128, 64), (64, 64, 8),
                                        (32, 32, 8), (128, 64, 32)])
    def test_the_f32_launch_refuses_pairs_it_lacks(self, blocks):
        with pytest.raises(ValueError, match="FMA"):
            K._kernel_tile(*blocks, "matmul_cuda", table=K.F32_BLOCKS)
        if blocks[0] == blocks[1]:
            with pytest.raises(KeyError):
                K.smem_footprint(blocks)

    @pytest.mark.parametrize("itemsize,edge", [(4, 704), (8, 384)])
    def test_the_demotion_edge(self, itemsize, edge):
        """At the chain's 64-wide tile the panel tier ends where a 64-row
        panel and K3's ring outgrow a block's shared memory (f64: the DMMA
        K3's 64 x 64 pair, whose ring of 16-deep stages took the edge from
        the FMA K3's 320² to 384²)."""
        taking_k3 = [p for p in range(256, 2048, 64)
                     if p * p * itemsize > K.SQUARE_SMEM_LIMIT
                     and K._resolve_tier(p, itemsize, 64, 64, 32,
                                         K.SQUARE_SMEM_LIMIT,
                                         K.SQUARE_PANEL_LIMIT) == "panel"]
        assert max(taking_k3) == edge
        assert K.panel_smem_footprint(edge, 64, 64, itemsize) \
            <= K.SMEM_PER_BLOCK \
            < K.panel_smem_footprint(edge + 64, 64, 64, itemsize)


def _dmma_model(blocks, footprint, steps, staged, flops):
    """The fp64 K2 / K3 grid model, restated: an SM runs ceil(blocks / 132)
    blocks, as many at once as its 228 KB of shared memory hold (1 KB kept
    per block); each wave waits through the K steps and copies the staged
    bytes; the SM's tensor cores do every block's flops."""
    per_sm = -(-blocks // 132)
    waves = -(-per_sm // max(1, min(233_472 // (footprint + 1024), 16)))
    return (waves * (steps * K.DMMA_STEP_NS + staged / K.DMMA_BLOCK_GBPS)
            + per_sm * flops / K.DMMA_SM_GFLOPS)


def _dmma_panel_cost(p, batch, height, width, groups):
    """The busiest SM of an fp64 K3 grid: a block stages its row panel and
    its column tiles, one ring step per K step of each."""
    block_k = K.dmma_panel_ring(p, height)[1]
    mine = -(-(p // width) // groups)
    return _dmma_model(groups * (p // height) * batch,
                       K.dmma_panel_smem_bytes(p, height),
                       mine * -(-p // block_k), (height + mine * width) * p * 8,
                       mine * 2 * height * width * p)


def _panel_load(p, batch, height, groups):
    """Output on the busiest SM of a K3 grid: blocks per SM times a block's
    column tiles times a tile's area."""
    width = K.panel_width(p)
    blocks = groups * (p // height) * batch
    return (-(-blocks // K.SM_COUNT) * -(-(p // width) // groups)
            * height * width)


PANEL_GRID_CASES = [
    pytest.param(p, tile, id=f"{p}-tile{tile}")
    for p in PANEL_SIZES for tile in K.KERNEL_TILES if p % tile == 0]


class TestPanelGrid:
    """K3 in f32 / f64 picks its own panel height and grid
    (``square_panel_grid``), the same function on the kernel route and in
    the plain version's bookkeeping (``last_launch``)."""

    def test_512_uses_at_least_128_blocks(self):
        assert K.square_panel_grid(512, 1, torch.float32, 64) == (32, 64, 8)
        a = torch.from_numpy(randn((512, 512), 44, 0.05))
        K.square_cuda(a, block_m=64, block_n=64, block_k=32)
        assert K.last_launch == dict(kernel="plain_square_panel", tile=32,
                                     width=64, blocks=128, groups=8)

    def test_the_panel_leaves_the_least_output_on_the_busiest_sm(self):
        # the stacked chain's (64, 256, 256): 256 blocks of one 64-row panel
        # that all fit the card at once (two per SM), not 512 blocks of 32
        # rows in two waves -- the same output per SM
        assert K.square_panel_grid(256, 64, torch.float32, 64) == (64, 64, 1)
        # an odd stack: 132 blocks either way, the taller panel
        assert K.square_panel_grid(128, 33, torch.float32, 64) == (64, 64, 2)
        # f64 at 256^2 (the DMMA K3): every 16 x 32 output tile its own
        # block, 128 of them
        assert K.square_panel_grid(256, 1, torch.float64, 64) == (16, 32, 8)
        # never taller than the chain's tile; 32 wide where 64 does not divide
        assert K.square_panel_grid(288, 1, torch.float32, 32) == (32, 32, 9)
        assert K.square_panel_grid(512, 1, torch.float32, 128) == (32, 64, 8)

    @pytest.mark.parametrize("batch", [1, 2, 7, 64])
    @pytest.mark.parametrize("p,chain_tile", PANEL_GRID_CASES)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_invariants(self, dtype, p, chain_tile, batch):
        height, width, groups = K.square_panel_grid(p, batch, dtype,
                                                    chain_tile)
        if dtype == torch.float64:
            # the DMMA K3: an instantiated pair, the least cost of all
            assert (height, width) in K.DMMA_PANELS
            assert height <= chain_tile and p % height == 0
            assert p % width == 0 and 1 <= groups <= p // width
            assert _dmma_panel_cost(p, batch, height, width, groups) == min(
                _dmma_panel_cost(p, batch, h, w, g)
                for h, w in K.DMMA_PANELS
                if h <= chain_tile and p % h == 0 and p % w == 0
                for g in range(1, p // w + 1))
            return
        assert (height, width) in K.FMA_PANELS
        assert width == K.panel_width(p) and p % width == 0
        assert height <= chain_tile and p % height == 0
        assert 1 <= groups <= p // width
        assert _panel_load(p, batch, height, groups) == min(
            _panel_load(p, batch, h, g)
            for h in (32, 64) if h <= chain_tile and p % h == 0
            for g in range(1, p // width + 1))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_16_bit_keeps_the_chain_tile(self, dtype):
        assert K.square_panel_grid(1024, 1, dtype, 64) == (64, 64, 9)
        a = torch.from_numpy(randn((256, 256), 45, 0.1)).to(dtype)
        K.square_cuda(a, block_m=64, block_n=64, block_k=64, smem_limit=0)
        assert K.last_launch == dict(kernel="plain_square_panel", tile=64,
                                     width=64, blocks=16, groups=4)

    def test_stacked_plain_route_records_the_grid(self):
        a = torch.from_numpy(randn((64, 256, 256), 46, 0.1))
        K.square_cuda(a, block_m=64, block_n=64, block_k=32)
        assert K.last_launch == dict(kernel="plain_square_panel", tile=64,
                                     width=64, blocks=256, groups=1)
        b = torch.from_numpy(randn((3, 256, 256), 47, 0.1)).double()
        K.square_cuda(b, block_m=64, block_n=64, block_k=32, smem_limit=0)
        assert K.last_launch == dict(kernel="plain_square_panel", tile=32,
                                     width=32, blocks=3 * 8 * 8, groups=8)

    def test_no_panel_height_divides_raises(self):
        with pytest.raises(ValueError, match="divides"):
            K.square_panel_grid(48, 1, torch.float32, 32)


DMMA_PANEL_PAIRS = [pytest.param(h, w, id=f"{h}x{w}") for h, w in
                    K.DMMA_PANELS]
DMMA_SIZES = [128, 192, 256, 288, 320, 384, 512]


def _dmma_whole_cost(p, batch, tile, groups):
    """The busiest SM of an fp64 K2 grid, restated: a matrix's first block
    (tiles 0, groups, ...) stages the boxes in its tiles' rows and columns,
    waits once and computes its tiles."""
    per_row = p // tile
    mine = list(range(0, per_row * per_row, groups))
    rows = len({t // per_row for t in mine}) * tile
    cols = len({t % per_row for t in mine}) * tile
    staged = (rows * p + cols * p - rows * cols) * 8
    return _dmma_model(groups * batch, K.whole_dmma_smem_bytes(p), 1, staged,
                       len(mine) * 2 * tile * tile * p)


class TestDmmaSquares:
    """What the Python side knows of the fp64 K2 and K3 of
    csrc/gemm_dmma.cuh: the tables, the shared memory each launcher asks
    for (the ``.cuh``'s formulas evaluated as written), the grid rules and
    the f64 tier edges they imply. On a CPU tensor the same tier and grid
    bookkeeping runs and ``last_launch`` shows the grid the kernel would
    get."""

    def test_tables_are_the_kernels(self):
        src = GEMM_DMMA.read_text()
        whole = re.findall(r"^\s*REPRO_WHOLE_DMMA\((\d+)\)\s*$", src,
                           flags=re.M)
        assert tuple(int(t) for t in whole) == K.WHOLE_DMMA_TILES
        panels = re.findall(
            r"^\s*REPRO_DMMA_PANEL\((\d+), (\d+), (\d+), (\d+)\)\s*$", src,
            flags=re.M)
        assert {(int(h), int(w), int(bk)): int(st)
                for h, w, bk, st in panels} == K.DMMA_PANEL_RINGS
        assert len(panels) == len(K.DMMA_PANEL_RINGS)
        # one width per height: dmma_panel_smem_bytes(p, height) is defined
        heights = [h for h, _ in K.DMMA_PANELS]
        assert len(set(heights)) == len(heights)
        # every pair has a ring whose K step divides every multiple of 32
        for h, w in K.DMMA_PANELS:
            assert min(bk for hh, ww, bk in K.DMMA_PANEL_RINGS
                       if (hh, ww) == (h, w)) <= 32

    def test_constants_are_the_kernels(self):
        consts = cuh_constants(GEMM_DMMA.read_text())
        assert consts["kBox"] == K.DMMA_BOX == 16
        assert consts["kSquareWarps"] == K.DMMA_SQUARE_WARPS == 4
        assert consts["kWholeRed"] == K.WHOLE_DMMA_RED
        assert consts["kSquareThreads"] == 128

    @pytest.mark.parametrize("tile", K.WHOLE_DMMA_TILES)
    def test_k_slices_and_partial_sums(self, tile):
        """``dmma_slices`` is ``SquareWarps::KS``, every K2 tile's partial
        sums fit ``kWholeRed``, and the slices take whole k8 steps."""
        warps = cuh_struct(GEMM_DMMA.read_text(), "SquareWarps", TM=tile,
                           TN=tile)
        assert warps["KS"] == K.dmma_slices(tile, tile)
        assert warps["OUT"] * warps["KS"] == K.DMMA_SQUARE_WARPS
        assert warps["RED"] <= K.WHOLE_DMMA_RED
        assert tile % K.DMMA_BOX == 0

    @pytest.mark.parametrize("p", DMMA_SIZES)
    @pytest.mark.parametrize("height,width", DMMA_PANEL_PAIRS)
    def test_k3_footprint_is_the_dmma_panel_formula(self, height, width, p):
        """The ring a launch takes is the deepest whose K step divides p,
        and its footprint is the ``.cuh``'s."""
        ring_w, bk, stages = K.dmma_panel_ring(p, height)
        assert ring_w == width and p % bk == 0
        assert all(p % other or other <= bk for h, w, other in
                   K.DMMA_PANEL_RINGS if (h, w) == (height, width))
        assert stages == K.DMMA_PANEL_RINGS[(height, width, bk)]
        src = GEMM_DMMA.read_text()
        panel = cuh_struct(src, "DmmaPanel", H=height, W=width, BK=bk,
                           STAGES=stages, P=p)
        assert K.dmma_panel_smem_bytes(p, height) == panel["bytes"]
        warps = cuh_struct(src, "SquareWarps", TM=height, TN=width)
        assert warps["OUT"] * warps["KS"] == K.DMMA_SQUARE_WARPS
        assert (bk // 8) % warps["KS"] == 0
        assert K.dmma_slices(height, width) == warps["KS"]

    @pytest.mark.parametrize("p", [32, 64, 96, 128, 160, 192])
    def test_k2_footprint_is_the_image_formula(self, p):
        want = cuh_struct(GEMM_DMMA.read_text(), "DmmaWhole", P=p)["bytes"]
        assert K.whole_dmma_smem_bytes(p) == want
        # the f64 whole tier (p^2 * 8 within a block's shared memory) fits
        # with the padding and the partial sums: up to 160^2
        assert (want <= K.SMEM_PER_BLOCK) == (p <= 160)
        assert K.square_tier(p * p * 8) == ("whole" if p <= 160 else "panel")

    def test_the_formula_reader_sees_a_changed_formula(self):
        src = GEMM_DMMA.read_text().replace("(size_t)H * (P + kPad) * 8",
                                            "(size_t)H * P * 8", 1)
        assert cuh_struct(src, "DmmaPanel", H=16, W=32, BK=32, STAGES=4,
                          P=256)["bytes"] != K.dmma_panel_smem_bytes(256, 16)
        src = GEMM_DMMA.read_text().replace("(KS - 1) * TM", "KS * TM", 1)
        assert cuh_struct(src, "DmmaPanel", H=16, W=32, BK=32, STAGES=4,
                          P=256)["bytes"] != K.dmma_panel_smem_bytes(256, 16)

    def test_a_height_without_a_pair_raises(self):
        with pytest.raises(KeyError):
            K.dmma_panel_smem_bytes(256, 48)
        # no K step divides 40: the shallowest ring's footprint, and the
        # shape is refused as not divisible, as in every dtype
        assert K.dmma_panel_ring(40, 64) == (64, 16, 3)
        with pytest.raises(ValueError, match="not divisible by blocks"):
            K.square_cuda(torch.zeros(200, 200, dtype=torch.float64),
                          block_m=64, block_n=64, block_k=32)

    @pytest.mark.parametrize("p,batch,grid", [
        (128, 1, (16, 64)), (160, 1, (16, 100)), (96, 1, (16, 36)),
        (128, 3, (16, 32)), (128, 32, (64, 4)), (128, 33, (64, 4)),
        (64, 132, (32, 4))])
    def test_k2_grid(self, p, batch, grid):
        """One matrix: 16-wide tiles, a block each (every block stages only
        its tile's rows and columns of A); a stack that fills the card on
        its own: 64-wide ones."""
        assert K.square_whole_grid(p, batch, torch.float64) == grid

    @pytest.mark.parametrize("batch", [1, 2, 3, 32, 33, 500])
    @pytest.mark.parametrize("p", [32, 64, 96, 128, 160])
    def test_k2_grid_invariants(self, p, batch):
        tile, groups = K.square_whole_grid(p, batch, torch.float64)
        assert tile in K.WHOLE_DMMA_TILES and p % tile == 0
        assert 1 <= groups <= (p // tile) ** 2
        assert _dmma_whole_cost(p, batch, tile, groups) == min(
            _dmma_whole_cost(p, batch, t, g) for t in K.WHOLE_DMMA_TILES
            if p % t == 0 for g in range(1, (p // t) ** 2 + 1))

    @pytest.mark.parametrize("p,batch,chain_tile,grid", [
        (128, 1, 64, (16, 32, 4)), (192, 1, 64, (16, 32, 6)),
        (256, 1, 64, (16, 32, 8)), (288, 1, 32, (16, 32, 9)),
        (320, 1, 64, (16, 32, 10)), (384, 1, 64, (32, 32, 6)),
        (256, 3, 64, (32, 32, 8)), (256, 64, 64, (32, 32, 1)),
        (128, 33, 64, (32, 32, 2)), (288, 3, 32, (32, 32, 9))])
    def test_k3_grid(self, p, batch, chain_tile, grid):
        """At 256^2, 128 blocks of one 16 x 32 tile (where the FMA K3 had
        32 blocks); the stacked chain's (64, 256, 256) on 32-row panels, a
        block a panel."""
        assert K.square_panel_grid(p, batch, torch.float64,
                                   chain_tile) == grid

    def test_no_f64_panel_divides_raises(self):
        with pytest.raises(ValueError, match="divides"):
            K.square_panel_grid(48, 1, torch.float64, 64)
        with pytest.raises(ValueError, match="divides"):
            K.square_whole_grid(40, 1, torch.float64)

    @pytest.mark.parametrize("p,tier", [
        (128, "whole"), (160, "whole"), (192, "panel"), (256, "panel"),
        (320, "panel"), (384, "panel"), (448, "two_operand"),
        (512, "two_operand")])
    def test_the_f64_tiers_at_the_chain_tile(self, p, tier):
        """The f64 demotion edge through ``_resolve_tier``: the DMMA K3's
        64-row panel fits up to 384^2 at the chain's tile 64."""
        assert K._resolve_tier(p, 8, 64, 64, 32, K.SQUARE_SMEM_LIMIT,
                               K.SQUARE_PANEL_LIMIT) == tier
        if tier != "whole":
            fits = K.dmma_panel_smem_bytes(p, 64) <= K.SMEM_PER_BLOCK
            assert fits == (tier == "panel")

    @pytest.mark.parametrize("shape,blocks,launch", [
        ((128, 128), (64, 64, 32),
         dict(kernel="plain_square_whole", tile=16, blocks=64, groups=64)),
        ((33, 128, 128), (64, 64, 32),
         dict(kernel="plain_square_whole", tile=64, blocks=132, groups=4)),
        ((256, 256), (64, 64, 32),
         dict(kernel="plain_square_panel", tile=16, width=32, blocks=128,
              groups=8)),
        ((2, 384, 384), (64, 64, 32),
         dict(kernel="plain_square_panel", tile=32, width=32, blocks=96,
              groups=4))])
    def test_plain_route_records_the_dmma_grid(self, shape, blocks, launch):
        """An f64 CPU tensor runs ``square_plain`` and records the grid the
        DMMA kernel would launch on, the product held to a float64 one."""
        a = randn(shape, 48, shape[-1] ** -0.5).astype(np.float64)
        bm, bn, bk = blocks
        got = K.square_cuda(torch.from_numpy(a), block_m=bm, block_n=bn,
                            block_k=bk)
        assert K.last_launch == launch
        assert got.dtype == torch.float64
        assert_close(got, np.matmul(a, a), "float64", n=shape[-1])
        assert K.launch_counts()[launch["kernel"]] == 1


class TestLaunchCounters:
    def test_cpu_tensors_count_the_plain_route_only(self):
        a = torch.from_numpy(randn((64, 64), 19, 0.2))
        K.matmul_cuda(a, a, block_m=32, block_n=32, block_k=32)
        K.square_cuda(a, block_m=32, block_n=32, block_k=32)
        counts = K.launch_counts()
        assert counts["plain_matmul"] == 1
        assert counts["plain_square_whole"] == 1
        assert counts["matmul"] == counts["square_whole"] == \
            counts["square_panel"] == 0
        assert counts["matmul_tc"] == counts["square_panel_tc"] == 0
        K.reset_launches()
        assert not any(K.launch_counts().values())
