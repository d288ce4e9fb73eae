"""``repro_torch`` flash attention vs ``repro`` (interpret mode).

The same numpy q, k, v (rounded once to the working dtype, by JAX) go
through the reference's ``ops.attention(..., interpret=True)`` — its Pallas
kernel body on the CPU — and the port's ``ops.attention`` on CPU tensors,
where the wrapper runs the same shape and block checks as on the card and
then the plain version. The split-KV arithmetic of the kernels
(``flash_attention_split_plain``: partial max, denominator and accumulator
per chunk of the KV band, then the combine) is held against both too, and
what the Python side knows of the CUDA sources (tile tables, shared-memory
formulas, the split rule) against those sources.

Tolerance, on the largest error over the largest entry of the reference's
output: 1e-5 in float32 (both compute the scores and the softmax in fp32 and
differ by summation order), 2^-8 in bfloat16 and 2^-10 in float16 (one unit
in the last place of the output type: the two round their fp32 results
once, at nearby values).
"""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import attention_kernels as A
from repro_torch.kernels import autotune, ops, ref

from _torch_parity import as_f64, cuh_constants, cuh_struct, pair

RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}
CSRC = Path(A.__file__).parent / "csrc"


@pytest.fixture(autouse=True)
def _fresh_counters():
    A.reset_launches()
    yield


def _only(**counts) -> dict:
    """Every launch counter 0 but the ones given."""
    return {**{name: 0 for name in A.LAUNCHES}, **counts}


def _qkv(lead, sq, skv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return [pair(rng.standard_normal((*lead, s, d)), dtype)
            for s in (sq, skv, skv)]


def _assert_close(got, want, dtype):
    g, w = as_f64(got), as_f64(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.isfinite(g).all()
    peak = np.abs(w).max()
    err = np.abs(g - w).max()
    assert err <= RTOL[dtype] * peak, (
        f"max error {err:.3e} is {err / peak:.3e} of the largest entry, "
        f"limit {RTOL[dtype]:.1e}")


def _reference(q, k, v, **kw):
    return jops.attention(q, k, v, interpret=True, **kw)


class TestReferenceCases:
    """The cases of tests/test_kernels.py::TestAttentionKernel, plus f16."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("cfg", [
        dict(sq=256, skv=256, d=64, causal=True, window=None),
        dict(sq=128, skv=512, d=64, causal=True, window=None),
        dict(sq=256, skv=256, d=128, causal=True, window=64),
        dict(sq=256, skv=256, d=64, causal=False, window=None),
    ])
    def test_flash_vs_reference(self, cfg, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), cfg["sq"], cfg["skv"],
                                            cfg["d"], dtype, 10)
        kw = dict(causal=cfg["causal"], window=cfg["window"])
        want = _reference(jq, jk, jv, block_q=128, block_k=128, **kw)
        got = ops.attention(tq, tk, tv, **kw)
        assert got.dtype == tq.dtype
        _assert_close(got, want, dtype)
        assert A.launch_counts() == _only(plain_flash_attention=1)

    def test_online_softmax_stability(self):
        """Large score magnitudes must not overflow the running max."""
        q = torch.full((128, 64), 30.0)
        rng = np.random.default_rng(13)
        v = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
        got = ops.attention(q, q, v, causal=True, block_q=128, block_k=128)
        assert not torch.isnan(got).any()


class TestMasksAndShapes:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("cfg", [
        dict(sq=256, skv=256, d=64, causal=True, window=32),
        dict(sq=64, skv=1024, d=64, causal=True, window=None),   # decode
        dict(sq=128, skv=512, d=128, causal=True, window=200),
        dict(sq=333, skv=333, d=64, causal=True, window=None),   # ragged
        dict(sq=192, skv=192, d=48, causal=True, window=None),   # d pads
        dict(sq=96, skv=96, d=256, causal=False, window=16),
    ])
    def test_vs_reference(self, cfg, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), cfg["sq"], cfg["skv"],
                                            cfg["d"], dtype, 20)
        kw = dict(causal=cfg["causal"], window=cfg["window"])
        _assert_close(ops.attention(tq, tk, tv, **kw),
                      _reference(jq, jk, jv, **kw), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_stack_is_the_vmap_of_the_reference(self, dtype):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 3), 128, 256, 64, dtype, 21)
        one = lambda q, k, v: _reference(q, k, v, causal=True, block_q=64,
                                         block_k=64)
        want = jax.vmap(jax.vmap(one))(jq, jk, jv)
        got = ops.attention(tq, tk, tv, causal=True)
        assert got.shape == (2, 3, 128, 64)
        _assert_close(got, want, dtype)
        assert A.launch_counts()["plain_flash_attention"] == 1  # one call

    def test_query_rows_before_every_key_are_zero(self):
        """Sq > Skv, causal: rows 0..127 sit before every key. Held against
        the reference's ORACLE, not its kernel: the kernel masks with the
        finite -1e30, so such a row gets exp(0) = 1 for every key and
        returns mean(v) (ROADMAP queue 3), where the oracle and its
        docstring give 0."""
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), 256, 128, 64, "float32", 22)
        got = ops.attention(tq, tk, tv, causal=True)
        want = jref.flash_attention_ref(jq, jk, jv, causal=True)
        assert torch.equal(got[:128], torch.zeros(128, 64))
        _assert_close(got, want, "float32")
        kernel = np.asarray(_reference(jq, jk, jv, causal=True, block_q=128,
                                       block_k=128))
        np.testing.assert_allclose(kernel[:128], np.broadcast_to(
            np.asarray(jv).mean(0), (128, 64)), atol=1e-6)

    def test_zero_padded_head_dim_is_exact(self):
        """What the kernel route does for a head dim it is not instantiated
        for: zero columns add nothing to q.k^T or p.v, and the scale stays
        that of the true width."""
        rng = np.random.default_rng(23)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 48))
                                    .astype(np.float32)) for _ in range(3))
        assert A.head_dim_for(48) == 64
        pad = lambda x: F.pad(x, (0, 16))
        got = A.flash_attention_plain(pad(q), pad(k), pad(v), causal=True,
                                      scale=48 ** -0.5)[..., :48]
        want = A.flash_attention_plain(q, k, v, causal=True)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_ref_computes_float64_in_fp32(self, dtype):
        rng = np.random.default_rng(24)
        q, k, v = (torch.from_numpy(rng.standard_normal((64, 64)))
                   .to(dtype) for _ in range(3))
        got = A.flash_attention_plain(q, k, v)
        assert got.dtype == dtype
        want = A.flash_attention_plain(q.float(), k.float(), v.float())
        torch.testing.assert_close(got.float(), want, rtol=0, atol=0)


class TestBlocks:
    def test_explicit_blocks_are_honoured_and_checked(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), 256, 256, 64, "float32", 30)
        got = ops.attention(tq, tk, tv, block_q=64, block_k=64)
        _assert_close(got, _reference(jq, jk, jv, block_q=64, block_k=64),
                      "float32")
        with pytest.raises(ValueError, match="not divisible"):
            ops.attention(tq, tk, tv, block_q=96, block_k=64)
        with pytest.raises(ValueError, match="not divisible"):
            jops.attention(jq, jk, jv, interpret=True, block_q=96, block_k=64)

    def test_blocks_clamp_to_the_sequence(self):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), 48, 48, 64, "float32", 31)
        got = ops.attention(tq, tk, tv, block_q=128, block_k=128)
        _assert_close(got, _reference(jq, jk, jv, block_q=128, block_k=128),
                      "float32")

    def test_a_block_no_tile_holds_raises_naming_the_tiles(self):
        (_, tq), (_, tk), (_, tv) = _qkv((), 512, 512, 128, "float32", 32)
        with pytest.raises(ValueError, match=r"instantiated.*\(128, 64\)"):
            ops.attention(tq, tk, tv, block_q=128, block_k=128)
        with pytest.raises(ValueError, match="instantiated"):
            ops.attention(tq, tk, tv, block_q=256, block_k=64)
        assert A.launch_counts()["plain_flash_attention"] == 0

    @pytest.mark.parametrize("d,tiles", [(16, 64), (64, 64), (65, 128),
                                         (128, 128), (200, 256), (256, 256)])
    def test_head_dims_pad_to_the_next_instantiated_width(self, d, tiles):
        assert A.head_dim_for(d) == tiles

    def test_head_dim_above_the_widest_raises(self):
        with pytest.raises(ValueError, match="head dim 300"):
            A.head_dim_for(300)

    @pytest.mark.parametrize("block,d,tile", [
        ((64, 64), 128, (64, 64)), ((111, 37), 64, (128, 64)),
        ((32, 16), 64, (64, 32)), ((128, 128), 128, None),
        ((96, 100), 256, None), ((64, 100), 128, (64, 128))])
    def test_kernel_tile_is_the_smallest_that_holds_the_block(self, block, d,
                                                              tile):
        assert A.kernel_tile(*block, d) == tile

    @pytest.mark.parametrize("family,source,macro,count", [
        ("fma", "attention.cuh", "REPRO_ATTN_TILE", 13),
        ("tc", "attention_tc.cuh", "REPRO_ATTN_TC_TILE", 9)])
    def test_tile_table_is_the_kernels(self, family, source, macro, count):
        """Each dtype family's ``ATTN_TILES`` table and its kernel's tile
        lines name the same (head width, tile_q, tile_k) instantiations: a
        tile the picker could choose but the library lacks would only show
        as a -1 from the launcher on the card. The 16-bit tiles are 64 or
        128 queries (one or two consumer warpgroups) and a multiple of 16
        keys, and every head width has one in both families. The FMA lines
        carry each tile's ring slots too (``ATTN_FMA_STAGES``)."""
        src = (CSRC / source).read_text()
        tail = r", (\d+)" if family == "fma" else ""
        lines = re.findall(
            rf"^\s*{macro}\((\d+), (\d+), (\d+){tail}\)\s*$", src,
            flags=re.M)
        if family == "fma":
            assert {tuple(int(x) for x in line[:3]): int(line[3])
                    for line in lines} == A.ATTN_FMA_STAGES
            assert all(int(line[3]) >= 2 for line in lines)
            lines = [line[:3] for line in lines]
        in_cuda = sorted(tuple(int(x) for x in line) for line in lines)
        in_python = sorted((d, tq, tk)
                           for d, tiles in A.ATTN_TILES[family].items()
                           for tq, tk in tiles)
        assert in_cuda == in_python and len(in_cuda) == count
        assert sorted(A.ATTN_TILES[family]) == list(A.HEAD_DIMS) \
            == [64, 128, 256]
        if family == "tc":
            assert all(tq in (64, 128) and tk % 16 == 0
                       for _, tq, tk in in_cuda)

    @pytest.mark.parametrize("sfx,header,api", [
        ("f32", "attention.cuh", "REPRO_DEFINE_ATTENTION_API(f32, float)"),
        ("f64", "attention.cuh", "REPRO_DEFINE_ATTENTION_API(f64, double)"),
        ("bf16", "attention_tc.cuh",
         "REPRO_DEFINE_ATTENTION_TC_API(bf16, __nv_bfloat16)"),
        ("f16", "attention_tc.cuh", "REPRO_DEFINE_ATTENTION_TC_API(f16, __half)")])
    def test_each_dtype_routes_to_its_kernel(self, sfx, header, api):
        """bf16 / f16 K5 is the tensor-core kernel only: the 16-bit units
        expand the tensor-core API and no FMA instantiation, and the FMA
        dispatch refuses 16-bit types at compile time."""
        unit = (CSRC / f"attention_{sfx}.cu").read_text()
        assert f'#include "{header}"' in unit and api in unit
        assert unit.count("REPRO_DEFINE_") == 1
        assert "static_assert(std::is_same<T, float>::value || " \
            "std::is_same<T, double>::value" in (CSRC / "attention.cuh") \
            .read_text()

    def test_every_tile_fits_shared_memory(self):
        for dtype in (torch.float32, torch.bfloat16):
            for d, tiles in A.attn_tiles(dtype).items():
                for tile in tiles:
                    assert A.attn_smem_footprint(*tile, d, dtype) <= 232_448
        # the FMA kernel at 64 x 64, d 128: Q 33,792 B, three ring slots of
        # a K or a V tile of 33,792 B each, P 64 x 72 floats
        assert A.attn_smem_footprint(64, 64, 128) \
            == 4 * 64 * 132 + 3 * 4 * 64 * 132 + 4 * 64 * 72 == 153_600
        # with copies in flight, Q 128 x 128 and two slots in flight beside
        # the one that computes fit at d = 128
        assert A.attn_smem_footprint(128, 64, 128) == 205_824
        # the tensor-core ring: Q 32 KB + 2 x (K 32 KB + V 32 KB) at
        # (128, 128, 128), one block per SM; Q 32 KB + 2 x (16 + 16) KB at
        # (128, 64, 128)
        assert A.attn_smem_footprint(128, 128, 128, torch.bfloat16) \
            == 1024 + 32768 + 2 * 65536 + 5 * 8
        assert A.attn_smem_footprint(128, 64, 128, torch.float16) \
            == 1024 + 32768 + 2 * 32768 + 5 * 8

    @pytest.mark.parametrize("d,tile", [
        (d, t) for d, ts in A.ATTN_TILES["fma"].items() for t in ts])
    def test_fma_footprint_is_the_cuh_formula(self, d, tile):
        """What ``attn_smem_footprint`` says an f32 / f64 block asks for is
        attention.cuh's ``Layout`` evaluated as written: Q, the tile's ring
        slots and P fit a block with at least two slots; at D = 128 a 128-row
        Q tile and a 64-key ring slot are 67.6 and 33.8 KB."""
        src = (CSRC / "attention.cuh").read_text()
        stages = A.ATTN_FMA_STAGES[(d, *tile)]
        layout = cuh_struct(src, "Layout", BQ=tile[0], BK=tile[1], D=d,
                            STAGES=stages)
        assert A.attn_smem_footprint(*tile, d, torch.float32) \
            == A.attn_smem_footprint(*tile, d, torch.float64) \
            == layout["BYTES"] <= 232_448
        assert layout["LD"] % 32 == 4
        # a split score product (fewer than 64 scores a thread) pads P rows
        # to 8 mod 32 banks, else to 16
        split = tile[0] * tile[1] < 64 * A.ATTN_THREADS
        assert layout["SPLIT"] == (2 if split else 1)
        assert layout["LDP"] % 32 == (8 if split else 16)
        assert cuh_constants(src)["kThreads"] == A.ATTN_THREADS
        assert cuh_struct(src.replace("STAGES * SLOT", "SLOT", 1), "Layout",
                          BQ=tile[0], BK=tile[1], D=d,
                          STAGES=stages)["BYTES"] != layout["BYTES"]

    @pytest.mark.parametrize("d,tile", [
        (d, t) for d, ts in A.ATTN_TILES["tc"].items() for t in ts])
    def test_tc_footprint_is_the_cuh_formula(self, d, tile):
        """What ``attn_smem_footprint`` says a 16-bit block asks for is what
        attention_tc.cuh's ``Smem`` formula, evaluated as written over
        gemm_tc.cuh's constants, gives."""
        src = (CSRC / "gemm_tc.cuh").read_text() \
            + (CSRC / "attention_tc.cuh").read_text()
        smem = cuh_struct(src, "Smem", TQ=tile[0], TK=tile[1], D=d)
        assert A.attn_smem_footprint(*tile, d, torch.bfloat16) \
            == smem["BYTES"] <= 232_448
        assert cuh_struct(src.replace("kStages * STAGE +", "STAGE +", 1),
                          "Smem", TQ=tile[0], TK=tile[1], D=d)["BYTES"] \
            != smem["BYTES"]

    @pytest.mark.parametrize("block,d,tile", [
        ((64, 64), 128, (64, 64)), ((111, 37), 64, (128, 64)),
        ((32, 16), 128, (64, 64)), ((128, 128), 128, (128, 128)),
        ((96, 100), 64, (128, 128)), ((64, 100), 128, (64, 128)),
        ((64, 64), 256, (64, 64)), ((65, 64), 256, None),
        ((128, 128), 256, None),
        ((64, 65), 256, None), ((129, 64), 64, None)])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_tc_kernel_tile_is_the_smallest_that_holds_the_block(
            self, block, d, tile, dtype):
        assert A.kernel_tile(*block, d, dtype) == tile
        assert A.kernel_name(dtype) == "flash_attention_tc"

    def test_a_16_bit_block_no_tc_tile_holds_raises_naming_the_tiles(self):
        (_, tq), (_, tk), (_, tv) = _qkv((), 256, 256, 256, "bfloat16", 34)
        with pytest.raises(ValueError, match=r"bfloat16.*\(64, 64\)"):
            ops.attention(tq, tk, tv, block_q=128, block_k=64)
        ops.attention(tq, tk, tv, block_q=64, block_k=64)
        assert A.launch_counts() == _only(plain_flash_attention=1)


class TestContracts:
    @pytest.mark.parametrize("shapes", [
        ((64, 32), (64, 16), (64, 16)), ((2, 64, 32), (3, 64, 32), (3, 64, 32)),
        ((64, 32), (64, 32), (32, 32)), ((32,), (32,), (32,)),
        ((0, 32), (64, 32), (64, 32))])
    def test_bad_shapes_raise(self, shapes):
        q, k, v = (torch.zeros(s) for s in shapes)
        with pytest.raises(ValueError, match="attention"):
            ops.attention(q, k, v)

    def test_mixed_dtypes_raise(self):
        q = torch.zeros(64, 32)
        with pytest.raises(ValueError, match="dtype"):
            ops.attention(q, q.double(), q)

    def test_cpu_counts_the_plain_route_only(self):
        q = torch.zeros(64, 32)
        ops.attention(q, q, q)
        A.flash_attention(q, q, q)
        A.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
        assert A.launch_counts() == _only(plain_flash_attention=3)
        A.reset_launches()
        assert not any(A.launch_counts().values())

    def test_auto_blocks_come_from_the_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                           str(tmp_path / "cache.json"))
        autotune.clear_memory_cache()
        try:
            autotune.record(256, 256, 64, (64, 32), kernel="attention",
                            dtype=torch.float32, backend="cpu")
            seen = {}
            real = ops.pick_attn_blocks

            def spy(*args, **kwargs):
                seen["blocks"] = real(*args, **kwargs)
                seen["backend"] = kwargs.get("backend")
                return seen["blocks"]

            monkeypatch.setattr(ops, "pick_attn_blocks", spy)
            (jq, tq), (jk, tk), (jv, tv) = _qkv((), 256, 256, 64, "float32",
                                                33)
            got = A.flash_attention(tq, tk, tv, causal=True)
            assert seen == {"blocks": (64, 32), "backend": "cpu"}
            _assert_close(got, jref.flash_attention_ref(jq, jk, jv),
                          "float32")
        finally:
            autotune.clear_memory_cache()


class TestRowRelativeError:
    """The yardstick K5 is held to on the card (``chip_smoke.py``,
    tests/test_torch_gpu.py): each query row's error over that row's
    largest entry."""

    @staticmethod
    def _dropping_a_tile(q, k, v, first_row, keys):
        """Causal attention in which rows from ``first_row`` on never see
        ``keys``: what a kernel that skipped one KV tile for the later query
        tiles would return."""
        sq, d = q.shape[-2:]
        pos = torch.arange(sq)
        mask = pos[None, :] <= pos[:, None]
        mask[first_row:, keys] = False
        scores = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        return (probs @ v.float()).to(q.dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_catches_a_dropped_tile_that_the_peak_limit_passes(self, dtype):
        """Small scores (q at a quarter of unit scale) spread each late row
        over ~1500 keys: its entries are a few hundredths, while row 0 is
        v[0] itself. Dropping 64 keys from rows 1536 on moves the output by
        under 1e-2 of its peak but by a third of those rows' own scale."""
        rng = np.random.default_rng(40)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 2048, 64))
                                    .astype(np.float32) * scale).to(dtype)
                   for scale in (0.25, 1.0, 1.0))
        want = A.flash_attention_plain(q, k, v, causal=True)
        bad = self._dropping_a_tile(q, k, v, 1536, slice(1024, 1088))
        peak_rel = ((bad.double() - want.double()).abs().max()
                    / want.double().abs().max()).item()
        assert peak_rel < 1e-2                 # a peak-relative limit passes it
        assert ref.row_relative_error(bad, want) > 0.3
        # a rounding-sized change of every entry stays inside the limit
        near = (want.float() * (1 + 2.0 ** -9)).to(dtype)
        assert ref.row_relative_error(near, want) <= 2.0 ** -7

    def test_a_row_that_must_be_zero_must_be_exactly_zero(self):
        want = torch.zeros(2, 4, 8)
        want[:, 2:] = 1.0
        got = want.clone()
        assert ref.row_relative_error(got, want) == 0.0
        got[0, 1, 3] = 1e-30
        assert ref.row_relative_error(got, want) == float("inf")
        got = want.clone()
        got[1, 3, 0] = 1.01
        assert ref.row_relative_error(got, want) == pytest.approx(0.01)


class TestSplitKvArithmetic:
    """The kernels' split-KV path in plain PyTorch: each block's band of KV
    tiles cut into chunks, each chunk's (max, denominator, unnormalised
    accumulator), then the combine. Held against the oracle and against the
    reference's kernel in interpret mode, at the fp32 limit: it is the same
    function in another order of summation."""

    @pytest.mark.parametrize("cfg", [
        dict(sq=256, skv=256, causal=True, window=None, bq=64, bk=32, z=3),
        dict(sq=256, skv=256, causal=True, window=48, bq=64, bk=16, z=4),
        dict(sq=64, skv=512, causal=True, window=None, bq=64, bk=64, z=5),
        dict(sq=128, skv=512, causal=True, window=200, bq=32, bk=64, z=2),
        dict(sq=128, skv=256, causal=False, window=None, bq=128, bk=32,
             z=8),
        dict(sq=192, skv=192, causal=False, window=40, bq=64, bk=16, z=3),
    ], ids=["causal", "window", "decode", "aligned_window", "full",
            "window_only"])
    def test_split_and_combine_is_attention(self, cfg):
        (jq, tq), (jk, tk), (jv, tv) = _qkv((2,), cfg["sq"], cfg["skv"], 64,
                                            "float32", 70)
        kw = dict(causal=cfg["causal"], window=cfg["window"])
        got = A.flash_attention_split_plain(
            tq, tk, tv, block_q=cfg["bq"], block_k=cfg["bk"],
            splits=cfg["z"], **kw)
        assert A.launch_counts() == _only(plain_attn_combine=1)
        oracle = lambda q, k, v: jref.flash_attention_ref(q, k, v, **kw)
        _assert_close(got, jax.vmap(oracle)(jq, jk, jv), "float32")
        one = lambda q, k, v: _reference(q, k, v, block_q=cfg["bq"],
                                         block_k=cfg["bk"], **kw)
        _assert_close(got, jax.vmap(one)(jq, jk, jv), "float32")
        torch.testing.assert_close(
            got, ref.flash_attention_ref(tq, tk, tv, **kw), rtol=0,
            atol=2e-6)

    def test_splits_that_see_no_key_weigh_nothing(self):
        """Causal, one 128-query block, 8 splits of one 16-key tile: for
        query row r the splits past its key r see no key at all (max -inf,
        denominator 0) and must drop out of the combine; a split whose max
        is -inf carries weight 0 even when another split's is -inf too."""
        (jq, tq), (jk, tk), (jv, tv) = _qkv((), 128, 128, 64, "float32", 71)
        assert [A.kv_range(0, 128, 128, 128, 16, True, None, z, 8)
                for z in range(8)] == [(16 * z, 1) for z in range(8)]
        got = A.flash_attention_split_plain(tq, tk, tv, block_q=128,
                                            block_k=16, splits=8)
        _assert_close(got, jref.flash_attention_ref(jq, jk, jv), "float32")
        part_o = torch.zeros(3, 2, 4)
        part_ml = torch.tensor([[[-math.inf, 0.0], [1.0, 2.0]],
                                [[-math.inf, 0.0], [3.0, 1.0]],
                                [[-math.inf, 0.0], [-math.inf, 0.0]]])
        part_o[0, 1], part_o[1, 1] = 1.0, 2.0
        out = A.attn_combine_plain(part_o, part_ml, torch.float32)
        assert torch.equal(out[0], torch.zeros(4))
        w0, w1 = 2.0 ** (1 - 3), 1.0
        torch.testing.assert_close(
            out[1], torch.full((4,), (w0 * 1 + w1 * 2) / (w0 * 2 + w1 * 1)))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_a_row_that_sees_no_key_is_exactly_zero(self, dtype):
        """Sq > Skv, causal: rows 0..127 sit before every key, so every split
        of their blocks is empty (no tile at all) and the combine's
        denominator is 0."""
        (jq, tq), (jk, tk), (jv, tv) = _qkv((2,), 256, 128, 64, dtype, 72)
        got = A.flash_attention_split_plain(tq, tk, tv, block_q=64,
                                            block_k=32, splits=3)
        assert got.dtype == tq.dtype
        assert torch.equal(got[:, :128], torch.zeros_like(got[:, :128]))
        _assert_close(got, jax.vmap(jref.flash_attention_ref)(jq, jk, jv),
                      dtype)

    def test_combine_kernel_wrapper_on_cpu_is_the_plain_version(self):
        rng = np.random.default_rng(73)
        part_o = torch.from_numpy(rng.standard_normal((4, 6, 64))
                                  .astype(np.float32))
        part_ml = torch.from_numpy(rng.standard_normal((4, 6, 2))
                                   .astype(np.float32)).abs()
        part_ml[1, 2, 0] = -math.inf
        out = torch.empty(6, 64, dtype=torch.bfloat16)
        assert A.attn_combine(part_o, part_ml, out) is out
        assert torch.equal(out, A.attn_combine_plain(part_o, part_ml,
                                                     torch.bfloat16))
        assert A.launch_counts() == _only(plain_attn_combine=2)
        with pytest.raises(ValueError, match="attn_combine"):
            A.attn_combine(part_o, part_ml[:, :, :1], out)
        with pytest.raises(ValueError, match="attn_combine"):
            A.attn_combine(part_o.double(), part_ml, out)


class TestSplitRule:
    SMS = 132

    @pytest.mark.parametrize("q_tiles,batch", [(1, 132), (2, 66), (32, 16),
                                               (64, 8), (200, 1)])
    def test_one_split_when_the_grid_fills_the_card(self, q_tiles, batch):
        assert A.kv_splits(q_tiles, batch, 64, self.SMS) == 1

    @pytest.mark.parametrize("q_tiles,batch,band,want", [
        (1, 16, 64, 16),     # decode f32: 17 wanted, 4-tile chunks -> 16
        (1, 16, 32, 16),     # decode bf16 at 128-key tiles
        (1, 1, 8, 8),        # never more than the band's tiles
        (1, 1, 1, 1),
        (2, 8, 100, 17),
        (1, 131, 64, 3),
    ])
    def test_splits(self, q_tiles, batch, band, want):
        got = A.kv_splits(q_tiles, batch, band, self.SMS)
        assert got == want
        assert 1 <= got <= band
        chunk = -(-band // got)
        assert (got - 1) * chunk < band        # no split of the band is empty

    @pytest.mark.parametrize("sq,skv,bq,bk,causal,window", [
        (128, 4096, 128, 64, True, None),
        (1, 4096, 1, 128, True, None),
        (128, 4096, 128, 128, True, 1000),
        (256, 256, 64, 32, True, 48),
        (96, 960, 32, 48, False, None),
        (256, 128, 64, 32, True, None),
    ])
    @pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
    def test_chunks_tile_the_band_on_block_k_borders(self, sq, skv, bq, bk,
                                                     causal, window, splits):
        """Every split's chunk starts on a multiple of ``block_k``; the
        chunks of a block are disjoint, in order, and together are exactly
        its band: the tiles holding some key a query of the block can see,
        and no other."""
        for q0 in range(0, sq, bq):
            first, band = A.kv_range(q0, bq, sq, skv, bk, causal, window)
            pos = torch.arange(q0, q0 + bq)[:, None] + (skv - sq)
            keys = torch.arange(skv)[None, :]
            seen = torch.ones(bq, skv, dtype=torch.bool)
            if causal:
                seen &= keys <= pos
            if window is not None:
                seen &= keys > pos - window
            tiles = {int(k) // bk for k in seen.any(0).nonzero()}
            assert set(range(first // bk, first // bk + band)) == tiles
            at = first
            for z in range(splits):
                begin, count = A.kv_range(q0, bq, sq, skv, bk, causal,
                                          window, z, splits)
                if count:
                    assert begin % bk == 0 and begin == at
                    at += count * bk
            assert at == first + band * bk
        assert A.band_tiles(sq, skv, bq, bk, causal, window) == max(
            A.kv_range(q0, bq, sq, skv, bk, causal, window)[1]
            for q0 in range(0, sq, bq))
