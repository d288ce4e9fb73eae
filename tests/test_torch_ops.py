"""``repro_torch.kernels.ops`` vs ``repro.kernels.ops`` (interpret mode).

Tile picking, padding, the arbitrary-shape ``matmul`` / ``square`` wrappers
and the chain executor's boundary contracts (pad once, unpad once, the
caller's tensor never written). The reference runs its Pallas kernels in
interpret mode with explicit 128-tiles; the port runs on CPU tensors through
the same padding / tier / chain logic it uses on the GPU. Tolerance:
``error_budget(dtype, n=K)``.
"""

import math

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import matmul_kernels as K
from repro_torch.kernels import ops

from _torch_parity import TORCH, assert_close, pair, randn, stochastic

REF_BLOCKS = (128, 128, 128)


@pytest.fixture(autouse=True)
def _fresh_counters():
    K.reset_launches()
    yield


class TestPickBlocks:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
    @pytest.mark.parametrize("n", [1, 7, 32, 33, 96, 200, 1000, 1536, 3000,
                                   4096])
    def test_invariants(self, n, dtype):
        bm, bn, bk = ops.pick_blocks(n, n, n, dtype=TORCH[dtype])
        assert bm == bn and bm in K.KERNEL_TILES
        assert bk >= 8 and bm % bk == 0
        itemsize = torch.empty((), dtype=TORCH[dtype]).element_size()
        assert K.smem_footprint((bm, bn, bk), itemsize) <= ops.SMEM_BUDGET
        assert K.smem_footprint((bm, bn, bk), itemsize) <= K.SMEM_PER_BLOCK

    @pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
    @pytest.mark.parametrize("n", [1, 7, 32, 33, 96, 200, 1000, 1536, 3000,
                                   4096])
    def test_sixteen_bit_picks_an_instantiated_pair(self, n, dtype):
        bm, bn, bk = ops.pick_blocks(n, n, n, dtype=TORCH[dtype])
        assert bm == bn and (bm, bk) in K.TC_BLOCKS and bm % bk == 0
        assert K.smem_footprint((bm, bn, bk), 2) <= ops.SMEM_BUDGET

    @pytest.mark.parametrize("n", [1, 7, 32, 33, 96, 200, 1000, 1536, 3000,
                                   4096])
    def test_f32_picks_an_instantiated_pair(self, n):
        bm, bn, bk = ops.pick_blocks(n, n, n, dtype=torch.float32)
        assert bm == bn and (bm, bk) in K.F32_BLOCKS and bm % bk == 0
        assert K.smem_footprint((bm, bn, bk)) <= ops.SMEM_BUDGET
        assert K.F32_STAGES[(bm, bk)] >= 2

    @pytest.mark.parametrize("n", [1, 7, 32, 33, 96, 200, 1000, 1536, 3000,
                                   4096])
    def test_f64_picks_an_instantiated_dmma_pair(self, n):
        bm, bn, bk = ops.pick_blocks(n, n, n, dtype=torch.float64)
        assert bm == bn and (bm, bk) in K.DMMA_BLOCKS and bm % bk == 0
        assert K.smem_footprint((bm, bn, bk), 8) <= ops.SMEM_BUDGET

    def test_f64_main_path_blocks(self):
        """The fp64 tensor-core K1 stops at tile 64: n = 4096 takes it too."""
        assert ops.pick_blocks(4096, 4096, 4096, dtype=torch.float64) == \
            (64, 64, 32)
        assert ops.pick_blocks(128, 128, 128, dtype=torch.float64) == \
            (64, 64, 32)
        assert ops.pick_blocks(20, 20, 20, dtype=torch.float64) == \
            (32, 32, 16)

    def test_sixteen_bit_k_step_is_the_default_where_it_fits(self):
        assert ops.pick_blocks(4096, 4096, 4096, dtype=torch.bfloat16) == \
            (128, 128, K.TC_DEFAULT_BK)
        assert ops.pick_blocks(512, 512, 512, dtype=torch.float16) == \
            (64, 64, K.TC_DEFAULT_BK)
        assert ops.pick_blocks(20, 20, 20, dtype=torch.bfloat16) == \
            (32, 32, 32)                          # at most the tile

    @pytest.mark.parametrize("n,padded", [(20, 32), (200, 256), (1000, 1024),
                                          (3000, 3072), (4096, 4096)])
    def test_sixteen_bit_padding_is_unchanged(self, n, padded):
        """The K step of the tensor-core kernels never pads a chain
        further than the f32 tiles do."""
        assert ops._square_blocks(n, torch.bfloat16)[1] == padded
        assert ops._square_blocks(n, torch.float32)[1] == padded

    def test_small_problems_do_not_take_the_largest_tile(self):
        """Sixteen 128-tiles would leave most SMs idle at n = 512."""
        assert ops.pick_blocks(512, 512, 512)[0] == 64
        assert ops.pick_blocks(4096, 4096, 4096)[0] == 128
        assert ops.pick_blocks(20, 20, 20)[0] == 32

    def test_budget_shrinks_the_k_step(self, monkeypatch):
        roomy = ops.pick_blocks(4096, 4096, 4096)
        # between the rings of the 128-wide tile's two K steps
        budget = K.fma_smem_bytes(128, 16)
        assert budget < K.fma_smem_bytes(128, 32)
        monkeypatch.setattr(ops, "SMEM_BUDGET", budget)
        tight = ops.pick_blocks(4096, 4096, 4096)
        assert tight[:2] == roomy[:2] and tight[2] < roomy[2]
        assert K.smem_footprint(tight) <= budget
        # below every ring of the tile: the smallest one, never a raise
        monkeypatch.setattr(ops, "SMEM_BUDGET", 12_000)
        assert ops.pick_blocks(4096, 4096, 4096) == tight

    @pytest.mark.parametrize("n,padded", [(1000, 1024), (3000, 3072),
                                          (4096, 4096), (96, 128), (200, 256),
                                          (20, 32), (1, 32)])
    def test_square_blocks_pad_to_the_tile(self, n, padded):
        blocks, p = ops._square_blocks(n, torch.float32)
        assert p == padded
        assert all(p % b == 0 for b in blocks)

    def test_explicit_blocks_are_honoured(self):
        blocks, p = ops._square_blocks(200, torch.float32, (128, 64, 32))
        assert blocks == (128, 64, 32)
        assert p == 256 == math.lcm(128, 64, 32) * 2


class TestPadToBlocks:
    def test_noop_returns_the_same_tensor(self):
        a = torch.ones(128, 64)
        assert ops.pad_to_blocks(a, 64, 32) is a

    def test_pads_trailing_dims_with_zeros(self):
        a = torch.ones(2, 5, 7)
        p = ops.pad_to_blocks(a, 4, 8)
        assert p.shape == (2, 8, 8)
        assert torch.equal(p[:, :5, :7], a)
        assert p.sum() == a.sum()

    def test_matches_reference_padding(self):
        a = randn((33, 70), 0)
        want = np.asarray(jops.pad_to_blocks(pair(a, "float32")[0], 32, 64))
        got = ops.pad_to_blocks(torch.from_numpy(a), 32, 64)
        np.testing.assert_array_equal(got.numpy(), want)


class TestMatmulWrapper:
    @pytest.mark.parametrize("mkn", [(33, 257, 129), (1, 128, 1),
                                     (130, 70, 50), (200, 200, 200)])
    def test_arbitrary_shapes(self, mkn):
        m, k, n = mkn
        ja, ta = pair(randn((m, k), 2, k ** -0.25), "float32")
        jb, tb = pair(randn((k, n), 3, k ** -0.25), "float32")
        want = jops.matmul(ja, jb, interpret=True, blocks=REF_BLOCKS)
        got = ops.matmul(ta, tb)
        assert got.shape == (m, n)
        assert_close(got, want, "float32", n=k)

    @pytest.mark.parametrize("form", ["both", "left", "right"])
    def test_stack_forms(self, form):
        a, b = randn((3, 130, 70), 4, 0.3), randn((3, 70, 50), 5, 0.3)
        if form == "left":
            b = b[0]
        if form == "right":
            a = a[0]
        ja, ta = pair(a, "float32")
        jb, tb = pair(b, "float32")
        want = jops.matmul(ja, jb, interpret=True, blocks=REF_BLOCKS)
        got = ops.matmul(ta, tb)
        assert_close(got, want, "float32", n=70)
        assert K.launch_counts()["plain_matmul"] == 1   # one call, whole stack

    def test_bf16_rounds_once(self):
        ja, ta = pair(randn((96, 200), 6, 0.2), "bfloat16")
        jb, tb = pair(randn((200, 40), 7, 0.2), "bfloat16")
        want = jops.matmul(ja, jb, interpret=True, blocks=REF_BLOCKS)
        got = ops.matmul(ta, tb)
        assert got.dtype == torch.bfloat16
        assert_close(got, want, "bfloat16", n=200)

    def test_mismatched_stacks_raise(self):
        with pytest.raises(ValueError, match="unsupported batch ranks"):
            ops.matmul(torch.zeros(2, 4, 4), torch.zeros(3, 4, 4))

    @pytest.mark.parametrize("n,out_dtype", [(64, torch.float32),
                                             (67, torch.float32),
                                             (64, torch.float64)],
                             ids=["kernel-writes-out", "padded-copy",
                                  "other-dtype"])
    def test_out_receives_the_result(self, n, out_dtype):
        """``out=``: written directly where no padding is needed (the
        sharded chain's ping-pong blocks), else the stripped result is
        copied in; either way ``out`` is returned, equal to the plain
        call."""
        a = torch.from_numpy(randn((n, n), 8, 0.2))
        b = torch.from_numpy(randn((n, n), 9, 0.2))
        out = torch.full((n, n), float("nan"), dtype=out_dtype)
        got = ops.matmul(a, b, out_dtype=out_dtype, out=out)
        assert got is out
        assert torch.equal(got, ops.matmul(a, b, out_dtype=out_dtype))


class TestSquareWrapper:
    @pytest.mark.parametrize("n", [96, 200])
    def test_arbitrary_square_shapes(self, n):
        ja, ta = pair(randn((n, n), 8, n ** -0.25), "float32")
        want = jops.square(ja, interpret=True, blocks=REF_BLOCKS)
        got = ops.square(ta)
        assert got.shape == (n, n)
        assert_close(got, want, "float32", n=n)

    def test_stack(self):
        a = randn((2, 3, 40, 40), 9, 0.2)
        got = ops.square(torch.from_numpy(a))
        assert got.shape == a.shape
        assert_close(got, np.matmul(a.astype(np.float64), a), "float32", n=40)


class TestChainBoundary:
    def test_chain_pads_exactly_once(self, monkeypatch):
        """ONE pad_to_blocks call per chain vs two per multiply (both
        operands) on the per-call route — the reference's single-pad
        counter test."""
        from repro_torch.core import matpow_binary
        calls = []
        real = ops.pad_to_blocks

        def counting(a, bm, bn):
            calls.append(tuple(a.shape))
            return real(a, bm, bn)

        monkeypatch.setattr(ops, "pad_to_blocks", counting)
        a = torch.from_numpy(stochastic(96, 4))
        matpow_binary(a, 9, backend="cuda_chain")        # 4 multiplies
        assert len(calls) == 1
        calls.clear()
        matpow_binary(a, 9, backend="cuda")
        assert len(calls) == 8                           # 2 operands x 4

    @pytest.mark.parametrize("n", [128, 96])
    def test_callers_tensor_is_never_written(self, n):
        """Divisible sizes included: pad is then a no-op, and the chain must
        still square a copy."""
        from repro_torch.core import matpow_binary
        a = torch.from_numpy(stochastic(n, 13))
        keep = a.clone()
        out = matpow_binary(a, 12, backend="cuda_chain")
        assert torch.equal(a, keep)
        assert out.data_ptr() != a.data_ptr()
        want = np.linalg.matrix_power(keep.double().numpy(), 12)
        assert_close(out, want, "float32", n=n, mults=4)

    def test_pad_copies_on_identity_pad_only_when_donating(self):
        a = torch.from_numpy(stochastic(128, 14))
        donating = ops.MatmulChain(128, torch.float32, blocks=(64, 64, 32))
        assert donating.padded_n == 128
        assert donating.pad(a).data_ptr() != a.data_ptr()
        keeping = ops.MatmulChain(128, torch.float32, blocks=(64, 64, 32),
                                  donate=False)
        assert keeping.pad(a) is a

    def test_donating_chain_ping_pongs_between_two_buffers(self):
        chain = ops.MatmulChain(64, torch.float32, blocks=(32, 32, 32))
        a = torch.from_numpy(stochastic(64, 15))
        x0 = chain.pad(a)
        p0 = x0.data_ptr()
        x1 = chain.square(x0)
        x2 = chain.square(x1)
        x3 = chain.square(x2)
        assert x1.data_ptr() != p0
        assert x2.data_ptr() == p0                 # x0's buffer, reused
        assert x3.data_ptr() == x1.data_ptr()
        want = np.linalg.matrix_power(a.double().numpy(), 8)
        assert_close(chain.unpad(x3), want, "float32", n=64, mults=3)

    def test_non_donating_chain_keeps_its_operand(self):
        chain = ops.MatmulChain(64, torch.float32, blocks=(32, 32, 32),
                                donate=False)
        x = torch.from_numpy(stochastic(64, 16))
        keep = x.clone()
        y1 = chain.square(x)
        y2 = chain.square(y1)
        chain.square(y2)
        assert torch.equal(x, keep)
        assert_close(y1, keep.double().numpy() @ keep.double().numpy(),
                     "float32", n=64)

    def test_unpad_strips_back(self):
        chain = ops.MatmulChain(96, torch.float32)
        x = chain.pad(torch.ones(96, 96))
        assert x.shape == (chain.padded_n,) * 2 and chain.padded_n > 96
        assert chain.unpad(x).shape == (96, 96)

    def test_chain_fixes_tiles_and_tiers_once(self):
        chain = ops.MatmulChain(200, torch.float32)
        chain.tiers = (1, 1 << 30)       # what a tuned entry would set
        x = chain.square(chain.pad(torch.from_numpy(stochastic(200, 17))))
        assert K.launch_counts()["plain_square_panel"] == 1
        assert x.shape == (chain.padded_n,) * 2
        default = ops.MatmulChain(200, torch.float32)
        assert default.tiers == (K.SQUARE_SMEM_LIMIT, K.SQUARE_PANEL_LIMIT)

    @pytest.mark.parametrize("n", [0, -1])
    def test_empty_chain_is_rejected(self, n):
        with pytest.raises(ValueError, match="n >= 1"):
            ops.MatmulChain(n, torch.float32)

    def test_unsupported_dtype_is_rejected(self):
        with pytest.raises(TypeError, match="unsupported dtype"):
            ops.MatmulChain(8, torch.int32)

    def test_stacked_chain_matches_reference_chain(self):
        a = stochastic(96, 18, batch=2)
        ja, ta = pair(a, "float32")
        jchain = jops.MatmulChain(96, ja.dtype, interpret=True, donate=False)
        want = jchain.unpad(jchain.square(jchain.square(jchain.pad(ja))))
        chain = ops.MatmulChain(96, torch.float32)
        got = chain.unpad(chain.square(chain.square(chain.pad(ta))))
        assert_close(got, want, "float32", n=96, mults=2)
        assert K.launch_counts()["plain_square_whole"] == 2   # one per step


class TestF64Chain:
    """The f64 chain on CPU tensors takes the tiers and grids that the fp64
    tensor-core K2 / K3 get on the card (``last_launch`` on the plain
    route): K2 at n = 128, K3 from 192² to the demotion edge at 384², K1
    past it; A^96 held to the float64 power under ``error_budget(float64, n,
    7)``."""

    @pytest.mark.parametrize("n,launch", [
        (128, dict(kernel="plain_square_whole", tile=16, blocks=64,
                   groups=64)),
        (200, dict(kernel="plain_square_panel", tile=16, width=32,
                   blocks=128, groups=8)),
        (256, dict(kernel="plain_square_panel", tile=16, width=32,
                   blocks=128, groups=8)),
        (320, dict(kernel="plain_square_panel", tile=16, width=32,
                   blocks=200, groups=10)),
        (400, dict(kernel="plain_matmul", tile=64, blocks=49))])
    def test_squaring_grid(self, n, launch):
        chain = ops.MatmulChain(n, torch.float64)
        assert chain.blocks == (64, 64, 32)
        x = chain.pad(torch.from_numpy(stochastic(n, 50).astype(np.float64)))
        chain.square(x)
        assert K.last_launch == launch

    @pytest.mark.parametrize("n,square", [(128, "plain_square_whole"),
                                          (256, "plain_square_panel")])
    def test_matpow_launches_and_budget(self, n, square):
        from repro_torch.core import matpow_binary
        a = stochastic(n, 51).astype(np.float64)
        ta = torch.from_numpy(a)
        got = matpow_binary(ta, 96, backend="cuda_chain")
        counts = {k: v for k, v in K.launch_counts().items() if v}
        assert counts == {square: 6, "plain_matmul": 1}
        assert got.dtype == torch.float64
        assert torch.equal(ta, torch.from_numpy(a))    # operand unaltered
        assert_close(got, np.linalg.matrix_power(a, 96), "float64", n=n,
                     mults=7)
