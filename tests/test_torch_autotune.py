"""The port's tuning cache (``repro_torch.kernels.autotune``) and the pickers
that consult it.

The cache's behavioural cases of the reference's tests/test_autotune.py and
tests/test_tuning.py, one by one, against the port: round-trip, corruption,
generation bumps, namespaces kept apart, re-validation of cached tiles by
``pick_blocks`` / ``pick_attn_blocks`` (entries that are invalid fall
through and never raise), the ragged and ``ValueError`` cases of the
attention heuristic, and the squaring tier limits reaching ``ops.square`` and
``MatmulChain``. Tiles are the port's (instantiated CUDA tiles, shared-memory
footprints), not the TPU's 128-multiples. Nothing here measures: sweeps run
with ``backend="cpu"``, which models.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro_torch.core import matpow_binary
from repro_torch.kernels import attention_kernels as A
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import matmul_kernels as K

from _torch_parity import stochastic

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    K.reset_launches()
    yield path
    autotune.clear_memory_cache()


class TestCacheRoundTrip:
    def test_record_then_lookup(self, tmp_cache):
        autotune.record(512, 512, 512, (64, 64, 16), dtype=F32)
        assert autotune.lookup(512, 512, 512, dtype=F32) == (64, 64, 16)

    def test_survives_reload_from_disk(self, tmp_cache):
        autotune.record(384, 384, 384, (128, 128, 32), dtype=BF16)
        autotune.clear_memory_cache()
        assert autotune.lookup(384, 384, 384, dtype=BF16) == (128, 128, 32)
        (key, entry), = json.loads(tmp_cache.read_text()).items()
        assert key == "matmul/384x384x384/bfloat16/cuda"
        assert entry["blocks"] == [128, 128, 32]

    def test_miss_returns_none(self, tmp_cache):
        assert autotune.lookup(640, 640, 640, dtype=F32) is None

    def test_dtype_keys_are_distinct(self, tmp_cache):
        autotune.record(512, 512, 512, (64, 64, 16), dtype=F32)
        assert autotune.lookup(512, 512, 512, dtype=BF16) is None

    def test_dtype_agnostic_entry_is_fallback(self, tmp_cache):
        autotune.record(512, 512, 512, (32, 32, 32), dtype=None)
        assert autotune.lookup(512, 512, 512, dtype=F32) == (32, 32, 32)

    def test_backend_segment_is_the_device_type(self, tmp_cache):
        autotune.record(512, 512, 512, (32, 32, 32), dtype=F32,
                        backend="cpu")
        assert autotune.lookup(512, 512, 512, dtype=F32,
                               backend="cpu") == (32, 32, 32)
        assert autotune.lookup(512, 512, 512, dtype=F32) is None  # "cuda"

    def test_the_port_has_its_own_file(self, tmp_cache, monkeypatch):
        assert autotune.cache_path() == tmp_cache
        monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_cache))
        assert autotune.cache_path().name == "autotune_torch.json"
        assert autotune.cache_path() != tmp_cache


class TestCorruptionRecovery:
    def test_corrupted_file_degrades_to_empty(self, tmp_cache):
        tmp_cache.write_text("{this is not json")
        with pytest.warns(UserWarning, match="corrupted autotune cache"):
            assert autotune.lookup(512, 512, 512, dtype=F32) is None

    def test_record_repairs_corrupted_file(self, tmp_cache):
        tmp_cache.write_text("[1, 2, 3]")
        with pytest.warns(UserWarning, match="corrupted autotune cache"):
            autotune.record(512, 512, 512, (64, 64, 16), dtype=F32)
        autotune.clear_memory_cache()
        assert autotune.lookup(512, 512, 512, dtype=F32) == (64, 64, 16)
        assert isinstance(json.loads(tmp_cache.read_text()), dict)

    def test_invalid_entries_filtered(self, tmp_cache):
        tmp_cache.write_text(json.dumps({
            "matmul/512x512x512/float32/cuda": {"blocks": "nope"},
            "matmul/256x256x256/float32/cuda": {"blocks": [64, 64, 16],
                                                "score": None,
                                                "measured": False},
            "square_panel/tiers/float32/cuda": {"tiers": [100, 10]},
        }))
        assert autotune.lookup(512, 512, 512, dtype=F32) is None
        assert autotune.lookup(256, 256, 256, dtype=F32) == (64, 64, 16)
        assert autotune.square_tiers(F32) == autotune.DEFAULT_SQUARE_TIERS

    def test_unwritable_location_warns_and_keeps_the_entry(
            self, tmp_path, monkeypatch):
        blocker = tmp_path / "file"
        blocker.write_text("")
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                           str(blocker / "cache.json"))
        autotune.clear_memory_cache()
        try:
            with pytest.warns(UserWarning, match="could not persist"):
                autotune.record(512, 512, 512, (64, 64, 16), dtype=F32)
            assert autotune.lookup(512, 512, 512, dtype=F32) == (64, 64, 16)
        finally:
            autotune.clear_memory_cache()


class TestNamespaces:
    def test_attention_record_then_lookup(self, tmp_cache):
        autotune.record(2048, 2048, 128, (128, 64), kernel="attention",
                        dtype=BF16)
        assert autotune.lookup(2048, 2048, 128, kernel="attention",
                               dtype=BF16) == (128, 64)

    def test_namespaces_are_distinct(self, tmp_cache):
        autotune.record(512, 512, 128, (64, 64, 16), dtype=F32)
        autotune.record(512, 512, 128, (64, 32), kernel="attention",
                        dtype=F32)
        assert autotune.lookup(512, 512, 128, dtype=F32) == (64, 64, 16)
        assert autotune.lookup(512, 512, 128, kernel="attention",
                               dtype=F32) == (64, 32)

    def test_two_element_blocks_survive_reload(self, tmp_cache):
        autotune.record(1024, 1024, 64, (64, 128), kernel="attention")
        autotune.clear_memory_cache()
        assert autotune.lookup(1024, 1024, 64,
                               kernel="attention") == (64, 128)

    def test_wrong_arity_blocks_never_cross_namespaces(self, tmp_cache):
        autotune.record(2048, 2048, 128, (128, 64), dtype=F32)
        assert autotune.lookup(2048, 2048, 128, dtype=F32) is None
        bm, bn, bk = ops.pick_blocks(2048, 2048, 128, dtype=F32)
        assert bm == bn and bm in K.KERNEL_TILES
        autotune.record(512, 512, 64, (64, 64, 16), kernel="attention")
        assert autotune.lookup(512, 512, 64, kernel="attention") is None

    def test_square_tiers_round_trip(self, tmp_cache):
        assert autotune.square_tiers(F32) == autotune.DEFAULT_SQUARE_TIERS
        autotune.record_square_tiers(4096, 1 << 20, dtype=F32)
        assert autotune.square_tiers(F32) == (4096, 1 << 20)
        autotune.clear_memory_cache()
        assert autotune.square_tiers(F32) == (4096, 1 << 20)

    def test_dtype_agnostic_tiers_are_the_fallback(self, tmp_cache):
        autotune.record_square_tiers(4096, 1 << 20, dtype=None)
        assert autotune.square_tiers(BF16) == (4096, 1 << 20)

    @pytest.mark.parametrize("tiers", [(1 << 20, 4096), (0, 4096),
                                       (-1, 4096)])
    def test_bad_records_raise(self, tmp_cache, tiers):
        with pytest.raises(ValueError):
            autotune.record_square_tiers(*tiers)
        assert not tmp_cache.exists()

    def test_the_ported_namespaces(self):
        """The serving engine's dispatch namespace came with the engine; the
        reference's fastmm and markov namespaces come with the slices that
        read them."""
        assert autotune.KERNELS == ("matmul", "attention", "square_panel",
                                    "dispatch")

    def test_measured_tiers_keep_their_probes(self, tmp_cache):
        autotune.record_square_tiers(4096, 1 << 20, dtype=F32, measured=True,
                                     probes_us={"128:whole": 6.5})
        autotune.clear_memory_cache()
        entry = autotune.load_cache()["square_panel/tiers/float32/cuda"]
        assert entry["probes_us"] == {"128:whole": 6.5}
        assert autotune.square_tiers(F32) == (4096, 1 << 20)


class TestGeneration:
    def test_every_mutation_bumps(self, tmp_cache):
        g0 = autotune.cache_generation()
        autotune.record(512, 512, 512, (64, 64, 16), dtype=F32, save=False)
        g1 = autotune.cache_generation()
        autotune.save_cache()
        g2 = autotune.cache_generation()
        autotune.clear_memory_cache()
        g3 = autotune.cache_generation()
        autotune.load_cache()
        assert g0 < g1 < g2 < g3 < autotune.cache_generation()

    def test_listeners_see_bumps_until_unsubscribed(self, tmp_cache):
        seen = []

        def broken(gen, reason):
            raise RuntimeError("observer failure must not break a retune")

        off_broken = autotune.on_generation_bump(broken)
        off = autotune.on_generation_bump(lambda g, r: seen.append(r))
        try:
            autotune.record_square_tiers(4096, 1 << 20, dtype=F32)
            assert "record:square_panel" in seen and "save" in seen
        finally:
            off()
            off_broken()
            off()                       # a second unsubscribe is a no-op
        count = len(seen)
        autotune.clear_memory_cache()
        assert len(seen) == count


class TestPickBlocks:
    def test_consults_cache(self, tmp_cache):
        autotune.record(777, 777, 777, (32, 32, 16), dtype=F32)
        assert ops.pick_blocks(777, 777, 777, dtype=F32) == (32, 32, 16)

    def test_heuristic_on_miss(self, tmp_cache):
        bm, bn, bk = ops.pick_blocks(4096, 4096, 4096)
        assert (bm, bn) == (128, 128) and bk % 8 == 0
        assert K.smem_footprint((bm, bn, bk)) <= ops.SMEM_BUDGET

    def test_cache_opt_out(self, tmp_cache):
        autotune.record(512, 512, 512, (128, 128, 16), dtype=F32)
        tuned = ops.pick_blocks(512, 512, 512, dtype=F32)
        heuristic = ops.pick_blocks(512, 512, 512, dtype=F32,
                                    use_cache=False)
        assert tuned == (128, 128, 16) and heuristic != tuned

    @pytest.mark.parametrize("bad", [
        (128, 64, 32),        # not square: the kernels take square tiles
        (16, 16, 16),         # not an instantiated tile
        (64, 64, 12),         # K step not a multiple of 8
        (128, 128, 512),      # 1.1 MB of staged tiles: over 227 KB
    ])
    def test_invalid_entries_fall_through_without_raising(self, tmp_cache,
                                                          bad):
        autotune.record(1024, 1024, 1024, bad, dtype=F32)
        assert autotune.lookup(1024, 1024, 1024, dtype=F32) == bad
        assert ops.pick_blocks(1024, 1024, 1024, dtype=F32) == \
            ops.pick_blocks(1024, 1024, 1024, dtype=F32, use_cache=False)

    def test_square_blocks_fall_back_when_the_lcm_blows_up(self, tmp_cache):
        autotune.record(20, 20, 20, (128, 128, 32), dtype=F32)
        blocks, padded = ops._square_blocks(20, F32)
        assert blocks == ops.pick_blocks(20, 20, 20, dtype=F32,
                                         use_cache=False)
        assert padded == 32                # not the 128 of the cached tile
        autotune.record(200, 200, 200, (128, 128, 16), dtype=F32)
        assert ops._square_blocks(200, F32) == ((128, 128, 16), 256)

    def test_matmul_keys_on_the_operands_device(self, tmp_cache, monkeypatch):
        autotune.record(96, 80, 64, (32, 32, 16), dtype=F32, backend="cpu")
        seen = []
        real = K.matmul_plain
        monkeypatch.setattr(K, "matmul_plain",
                            lambda a, b, **kw: seen.append(kw) or real(a, b,
                                                                        **kw))
        a, b = torch.ones(96, 64), torch.ones(64, 80)
        torch.testing.assert_close(ops.matmul(a, b), a @ b)
        assert seen[0]["block_m"] == 32 and seen[0]["block_k"] == 16


class TestSweep:
    def test_sweep_populates_cache(self, tmp_cache):
        cands = [(32, 32, 16), (64, 64, 32)]
        best, results = autotune.sweep(256, 256, 256, dtype=F32,
                                       candidates=cands, backend="cpu")
        assert best in cands and len(results) == 2
        assert not any(r["measured"] for r in results)
        assert autotune.lookup(256, 256, 256, dtype=F32,
                               backend="cpu") == best

    def test_modeled_sweep_is_deterministic(self, tmp_cache):
        best1, _ = autotune.sweep(300, 300, 300, dtype=F32, measure=False,
                                  save=False)
        best2, _ = autotune.sweep(300, 300, 300, dtype=F32, measure=False,
                                  save=False)
        assert best1 == best2 and not tmp_cache.exists()

    def test_model_follows_the_card(self, tmp_cache):
        """Large problems fill 132 SMs with 128-tiles; at n = 512 only 16
        of them exist, and a smaller tile wins, as the heuristic says."""
        assert autotune.sweep(4096, 4096, 4096, measure=False,
                              save=False)[0][0] == 128
        assert autotune.sweep(512, 512, 512, measure=False,
                              save=False)[0][0] < 128

    @pytest.mark.parametrize("blocks", [(256, 256, 32), (128, 128, 512),
                                        (64, 32, 16)])
    def test_tiles_the_kernels_cannot_run_score_inf(self, blocks):
        assert autotune.modeled_score(4096, 4096, 4096, blocks,
                                      F32) == float("inf")

    def test_every_default_candidate_can_run(self):
        """Each dtype's default candidates run on its kernel: the FMA list
        on f32 (f64's K1 is the fp64 tensor-core kernel, which takes only
        its instantiated pairs), the tensor-core lists on theirs."""
        for blocks in autotune.DEFAULT_CANDIDATES:
            assert autotune.valid_blocks(blocks, itemsize=4)
        for blocks in autotune.DMMA_CANDIDATES:
            assert autotune.valid_blocks(blocks, itemsize=8)
        for blocks in autotune.TC_CANDIDATES:
            assert autotune.valid_blocks(blocks, itemsize=2)

    @pytest.mark.parametrize("tile,bk", K.TC_BLOCKS)
    def test_sixteen_bit_accepts_each_instantiated_pair(self, tile, bk):
        assert autotune.valid_blocks((tile, tile, bk), itemsize=2)

    @pytest.mark.parametrize("tile", K.KERNEL_TILES)
    def test_sixteen_bit_refuses_k_step_8(self, tile):
        assert not autotune.valid_blocks((tile, tile, 8), itemsize=2)
        # the f32 K1's K step is compile-time too: 16 and 32, not 8
        assert not autotune.valid_blocks((tile, tile, 8), itemsize=4)
        assert autotune.valid_blocks((tile, tile, 16), itemsize=4)
        assert not autotune.valid_blocks((tile, tile, 16), itemsize=2)

    @pytest.mark.parametrize("tile,bk", K.F32_BLOCKS)
    def test_f32_accepts_each_instantiated_pair(self, tile, bk):
        assert autotune.valid_blocks((tile, tile, bk), itemsize=4)
        assert (tile, tile, bk) in autotune.DEFAULT_CANDIDATES

    @pytest.mark.parametrize("blocks", [(64, 64, 64), (128, 128, 64),
                                        (32, 32, 8), (64, 64, 24)])
    def test_f32_refuses_pairs_it_does_not_instantiate(self, blocks):
        assert not autotune.valid_blocks(blocks, itemsize=4)
        assert autotune.modeled_score(1024, 1024, 1024, blocks,
                                      F32) == float("inf")

    def test_sixteen_bit_refuses_a_ring_over_shared_memory(self):
        assert not autotune.valid_blocks((128, 128, 128), itemsize=2)
        assert not autotune.valid_blocks((64, 64, 16), itemsize=2)

    def test_sixteen_bit_sweep_scores_the_instantiated_pairs(self, tmp_cache):
        best, results = autotune.sweep(512, 512, 512, dtype=BF16,
                                       backend="cpu")
        assert sorted(r["blocks"] for r in results) == \
            sorted(autotune.TC_CANDIDATES)
        assert all(math.isfinite(r["score"]) for r in results)
        assert (best[0], best[2]) in K.TC_BLOCKS

    def test_sixteen_bit_entry_the_kernels_lack_falls_through(self,
                                                              tmp_cache):
        autotune.record(1024, 1024, 1024, (64, 64, 16), dtype=BF16)
        assert ops.pick_blocks(1024, 1024, 1024, dtype=BF16) == \
            ops.pick_blocks(1024, 1024, 1024, dtype=BF16, use_cache=False)
        autotune.record(1024, 1024, 1024, (128, 128, 32), dtype=BF16)
        assert ops.pick_blocks(1024, 1024, 1024, dtype=BF16) == \
            (128, 128, 32)

    def test_chain_uses_tuned_blocks(self, tmp_cache):
        autotune.record(200, 200, 200, (128, 128, 32), dtype=F32,
                        backend="cpu")
        chain = ops.MatmulChain(200, F32, device="cpu")
        assert chain.blocks == (128, 128, 32) and chain.padded_n == 256
        assert ops.MatmulChain(200, F32).blocks != (128, 128, 32)  # "cuda"
        a = torch.from_numpy(stochastic(200, 5))
        got = matpow_binary(a, 5, backend="cuda_chain")
        want = np.linalg.matrix_power(a.double().numpy(), 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)

    def test_measuring_off_the_card_raises(self, tmp_cache):
        if torch.cuda.is_available():
            pytest.skip("this machine has a GPU")
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune.sweep(256, 256, 256, candidates=[(64, 64, 16)])
        with pytest.raises(RuntimeError, match="CUDA"):
            autotune.sweep_attention(256, 256, 64, candidates=[(64, 64)])
        assert not tmp_cache.exists()


class TestAttentionSweep:
    def test_measured_sweep_skips_rejected_candidates(self, tmp_cache,
                                                      monkeypatch):
        def fake_measure(sq, skv, d, blocks, dtype, reps=3):
            if blocks == (128, 128):
                raise ValueError("no attention kernel tile holds blocks")
            return float(sum(blocks))

        monkeypatch.setattr(autotune, "measure_attn_us", fake_measure)
        best, results = autotune.sweep_attention(
            1536, 1536, 128, dtype=F32, measure=True,
            candidates=[(128, 128), (64, 64)])
        assert best == (64, 64)
        scores = {r["blocks"]: r["score"] for r in results}
        assert scores[(128, 128)] == float("inf")
        entry = autotune.load_cache()["attention/1536x1536x128/float32/cuda"]
        assert entry["measured"] is True and entry["score"] == 128.0

    def test_modeled_sweep_populates_namespace(self, tmp_cache):
        best, results = autotune.sweep_attention(
            1024, 1024, 128, dtype=F32, candidates=[(64, 64), (128, 64)],
            backend="cpu")
        assert best in [(64, 64), (128, 64)] and len(results) == 2
        assert autotune.lookup(1024, 1024, 128, kernel="attention",
                               dtype=F32, backend="cpu") == best

    def test_model_rejects_what_no_tile_holds(self):
        """Per dtype family: the FMA kernel has no (128, 128) tile at d 128,
        the tensor-core kernel has one there but none at d 256."""
        assert autotune.modeled_attn_score(4096, 4096, 128, (128, 128),
                                           F32) == float("inf")
        assert autotune.modeled_attn_score(4096, 4096, 128, (128, 128),
                                           BF16) < float("inf")
        assert autotune.modeled_attn_score(4096, 4096, 256, (128, 128),
                                           BF16) == float("inf")
        assert autotune.modeled_attn_score(4096, 4096, 64, (128, 128),
                                           BF16) < float("inf")

    def test_default_candidates_are_the_instantiated_tiles(self):
        for family, candidates, dtype in (
                ("fma", autotune.DEFAULT_ATTN_CANDIDATES, F32),
                ("tc", autotune.TC_ATTN_CANDIDATES, BF16)):
            tiles = {t for ts in A.ATTN_TILES[family].values() for t in ts}
            assert set(candidates) == tiles
            assert autotune.attn_candidates(dtype) == candidates

    def test_16_bit_sweep_scores_the_tensor_core_tiles(self, tmp_cache,
                                                       monkeypatch):
        seen = []

        def fake_measure(sq, skv, d, blocks, dtype, reps=3):
            seen.append((blocks, dtype))
            return float(blocks[0] * blocks[1])

        monkeypatch.setattr(autotune, "measure_attn_us", fake_measure)
        best, results = autotune.sweep_attention(4096, 4096, 128, dtype=BF16,
                                                 measure=True)
        assert [b for b, _ in seen] == list(autotune.TC_ATTN_CANDIDATES)
        assert {dt for _, dt in seen} == {BF16}
        assert best == (64, 64) and len(results) == 4   # 4 distinct tiles
        assert autotune.lookup(4096, 4096, 128, kernel="attention",
                               dtype=BF16) == (64, 64)


class TestPickAttnBlocks:
    def test_consults_cache(self, tmp_cache):
        autotune.record(256, 256, 64, (64, 32), kernel="attention",
                        dtype=F32)
        assert ops.pick_attn_blocks(256, 256, 64, dtype=F32) == (64, 32)

    @pytest.mark.parametrize("sq,skv,d,want", [
        (2048, 2048, 128, (128, 64)),   # (128, 128) is not instantiated
        (2048, 2048, 64, (128, 128)),
        (128, 512, 64, (128, 128)),
        (4096, 4096, 128, (128, 64)),
        (48, 48, 64, (48, 48)),         # whole axis, clamped
        (333, 333, 64, (111, 111)),     # largest divisor <= 128
        (333, 333, 128, (111, 37)),     # ... then the next that a tile holds
        (127, 127, 64, (127, 127)),     # prime within one tile: whole axis
        (96, 96, 256, (48, 48)),
    ])
    def test_heuristic(self, tmp_cache, sq, skv, d, want):
        got = ops.pick_attn_blocks(sq, skv, d)
        assert got == want
        assert autotune.attn_blocks_usable(sq, skv, d, got)

    @pytest.mark.parametrize("sq,skv,d,want", [
        (4096, 4096, 128, (128, 128)),  # the tensor-core kernel has it
        (128, 4096, 128, (128, 128)),
        (2048, 2048, 256, (64, 64)),    # d 256: (64, 64) is the only tile
        (333, 333, 128, (111, 111)),
        (96, 96, 256, (48, 48)),
    ])
    @pytest.mark.parametrize("dtype", [BF16, torch.float16])
    def test_heuristic_on_the_16_bit_tiles(self, tmp_cache, sq, skv, d, want,
                                           dtype):
        got = ops.pick_attn_blocks(sq, skv, d, dtype=dtype)
        assert got == want
        assert autotune.attn_blocks_usable(sq, skv, d, got, dtype)
        assert A.kernel_tile(*got, d, dtype) is not None

    def test_heuristic_divides_ragged_lengths(self, tmp_cache):
        bq, bk = ops.pick_attn_blocks(384, 768, 64)
        assert 384 % bq == 0 and 768 % bk == 0

    @pytest.mark.parametrize("sq,d", [(331, 64), (10007, 128), (256, 300)])
    def test_no_tiling_raises_with_guidance(self, tmp_cache, sq, d):
        with pytest.raises(ValueError, match="pad the sequence"):
            ops.pick_attn_blocks(sq, sq, d)

    @pytest.mark.parametrize("entry,sq,d", [
        ((100, 128), 256, 64),    # does not divide 256
        ((256, 128), 384, 64),    # clamped 256 does not divide 384
        ((128, 128), 2048, 128),  # no instantiated tile holds it at d 128
        ((64, 128), 256, 256),    # nor at d 256
    ])
    def test_invalid_entries_fall_through_without_raising(self, tmp_cache,
                                                          entry, sq, d):
        autotune.record(sq, sq, d, entry, kernel="attention", dtype=F32)
        got = ops.pick_attn_blocks(sq, sq, d, dtype=F32)
        assert got != entry
        assert got == ops.pick_attn_blocks(sq, sq, d, dtype=F32,
                                           use_cache=False)


class TestTiersReachTheKernels:
    def test_square_takes_tuned_tiers(self, tmp_cache):
        """192 x 192 f32 = 144 KB fits the whole-operand tier by default; a
        tuned limit below it sends the squaring to the panel kernel."""
        a = torch.from_numpy(stochastic(192, 6))
        ops.square(a)
        assert K.launch_counts()["plain_square_whole"] == 1
        autotune.record_square_tiers(64 * 1024, 8 * 1024 * 1024, dtype=F32,
                                     backend="cpu")
        got = ops.square(a)
        assert K.launch_counts()["plain_square_panel"] == 1
        torch.testing.assert_close(got, (a.double() @ a.double()).float())

    def test_chain_inherits_tuned_tiers(self, tmp_cache):
        autotune.record_square_tiers(64 * 1024, 8 * 1024 * 1024, dtype=F32,
                                     backend="cpu")
        chain = ops.MatmulChain(192, F32, device="cpu")
        assert chain.tiers == (64 * 1024, 8 * 1024 * 1024)
        assert ops.MatmulChain(192, F32).tiers == \
            autotune.DEFAULT_SQUARE_TIERS
        a = torch.from_numpy(stochastic(192, 7))
        got = chain.unpad(chain.square(chain.pad(a)))
        assert K.launch_counts()["plain_square_panel"] == 1
        torch.testing.assert_close(got, (a.double() @ a.double()).float())

    @staticmethod
    def _fake_card(monkeypatch, times):
        """Run the measured tier sweep on the CPU: every probe's samples come
        from ``times``, keyed by the tier the probe's limits send it to."""
        import repro_torch
        limits = {}
        monkeypatch.setattr(repro_torch, "default_device",
                            lambda device=None: torch.device("cpu"))
        monkeypatch.setattr(K, "square_cuda",
                            lambda a, smem_limit, panel_limit, **kw:
                            limits.update(smem=smem_limit, panel=panel_limit))

        def fake_times(fn, reps=5):
            fn()
            tier = ("matmul" if limits["panel"] == 0 else
                    "panel" if limits["smem"] == 0 else "whole")
            return times[tier]

        monkeypatch.setattr(autotune, "device_times_us", fake_times)

    @pytest.mark.parametrize("times,moved", [
        # inside the spread: the defaults stay
        (dict(whole=[10, 12, 11], panel=[9, 11.5, 10.5],
              matmul=[30, 29, 31]), ()),
        # K3 beats K2 with every sample: the whole-operand tier shrinks
        (dict(whole=[10, 10.5, 11], panel=[8, 9, 9.5],
              matmul=[30, 29, 31]), ("whole",)),
        # K1 beats K3 with every sample: the panel tier shrinks
        (dict(whole=[10, 10.5, 11], panel=[30, 31, 40],
              matmul=[20, 25, 29]), ("panel",)),
    ])
    def test_measured_tiers_move_only_past_the_spread(self, tmp_cache,
                                                      monkeypatch, times,
                                                      moved):
        self._fake_card(monkeypatch, times)
        whole, panel = autotune.sweep_square_tiers(F32)
        d_whole, d_panel = autotune.DEFAULT_SQUARE_TIERS
        assert (whole != d_whole) == ("whole" in moved)
        assert (panel != d_panel) == ("panel" in moved)
        if "whole" in moved:           # just below the 128^2 f32 operand
            assert whole == 128 * 128 * 4 - 1
        if "panel" in moved:
            p = math.isqrt((panel + 1) // 4)
            assert p * p * 4 == panel + 1 and p > 128
        entry = autotune.load_cache()["square_panel/tiers/float32/cuda"]
        assert entry["measured"] is True
        probes = entry["probes_us"]      # two sizes, two tiers each
        assert len(probes) == 4
        assert probes["128:whole"] == float(np.median(times["whole"]))

    def test_modeled_tier_sweep_records_defaults(self, tmp_cache):
        tiers = autotune.sweep_square_tiers(F32, backend="cpu")
        assert tiers == autotune.DEFAULT_SQUARE_TIERS
        assert autotune.square_tiers(F32, "cpu") == tiers
        entry = autotune.load_cache()["square_panel/tiers/float32/cpu"]
        assert entry["measured"] is False
