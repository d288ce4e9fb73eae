"""The port's Strassen route (``repro_torch.kernels.fastmm``) on the CPU.

The reference's tests/test_fastmm.py on CPU tensors, where every leaf is K1's
plain version through ``ops.matmul``: the recursion at odd and prime sizes,
the depth cap and crossover policy (7^L leaves, one dense leaf below the
crossover), the ``fastmm`` namespace of the tuning cache (round trip,
corruption, leaf tiles K1 does not run), the chain's fast route, the
engine's ``fastmm`` route and the acceptance gate (matpow on
``"cuda_fastmm"`` within ``error_budget(levels=...)`` while the dense routes
keep their bits). Then the port's own:

  * parity with the reference's ``strassen_matmul(..., interpret=True)`` on
    the same numpy operands (n in {17, 33, 64}, levels 1-2, crossover
    8-16, float32 and bfloat16), both held to float64 and to each other
    under ``error_budget(levels=...)``;
  * the leaves are ``ops.matmul`` — counted by K1's launch counter, never
    ``torch.matmul`` — and pad to their own tiles only (a 3072 chain's
    1536 halves stay 1536);
  * twins of the Strassen properties of tests/test_chains_property.py.

bfloat16 at two levels has rtol 0.6 (the dense 0.15 doubled twice): a
bf16 Strassen product may be off by most of an entry where the entries
cancel; what it bounds is the accumulated rounding of the combine adds,
about a bit a level, not a useful relative accuracy.
"""

import json

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from _torch_parity import TORCH, as_f64, pair

from repro_torch.core import batched_matpow, matpow_binary, matpow_binary_traced
from repro_torch.kernels import autotune, fastmm, ops
from repro_torch.kernels import matmul_kernels as K
from repro_torch.serve.matfn import ROUTES, MatFnEngine

pytestmark = pytest.mark.timeout(120)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def _np_mat(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return a / max(np.linalg.norm(a, 2), 1e-12) * 0.9


def _mat(n, seed, dtype=torch.float32):
    return torch.tensor(_np_mat(n, seed), dtype=dtype)


def _matpow_mults(p):
    if p <= 1:
        return 1
    return (p.bit_length() - 1) + (bin(p).count("1") - 1)


def _within(got, want, dtype=None, *, levels=0, n=None, mults=1):
    """``got`` within ``error_budget(dtype, levels, n, mults)`` of the
    float64 ``want``."""
    dtype = dtype or got.dtype
    n = n if n is not None else got.shape[-1]
    rtol, atol = fastmm.error_budget(dtype, levels=levels, n=n, mults=mults)
    np.testing.assert_allclose(as_f64(got), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


class TestStrassenCorrectness:
    @pytest.mark.parametrize("n", [3, 7, 13, 97, 101])
    def test_matches_reference_at_odd_and_prime_n_f32(self, n):
        """Full-depth recursion through odd sub-sizes (every level pads one
        row and column) lands inside the per-level budget."""
        a, b = _mat(n, seed=n), _mat(n, seed=n + 1)
        got = fastmm.strassen_matmul(a, b, levels=3, crossover=2)
        want = a.double().numpy() @ b.double().numpy()
        assert got.dtype == a.dtype
        _within(got, want, levels=fastmm.plan_levels(n, levels=3,
                                                     crossover=2))

    @pytest.mark.parametrize("n", [7, 53, 96])
    def test_matches_reference_bf16(self, n):
        a = _mat(n, seed=n, dtype=torch.bfloat16)
        b = _mat(n, seed=n + 9, dtype=torch.bfloat16)
        got = fastmm.strassen_matmul(a, b, levels=2, crossover=4)
        want = a.double().numpy() @ b.double().numpy()
        assert got.dtype == torch.bfloat16
        _within(got, want, levels=fastmm.plan_levels(n, 2, 4))

    def test_batched_operands_carry_through(self):
        """Leading stack dims ride the quadrant slicing, and each leaf is
        ONE launch for the whole stack."""
        rng = np.random.default_rng(3)
        stack = torch.tensor(rng.standard_normal((4, 10, 10)) * 0.3,
                             dtype=torch.float32)
        K.reset_launches()
        got = fastmm.strassen_square(stack, levels=2, crossover=2)
        assert K.launch_counts()["plain_matmul"] == 49
        for i in range(4):
            want = stack[i].double().numpy()
            _within(got[i], want @ want, levels=2, n=10)

    def test_rejects_non_square_or_mismatched(self):
        with pytest.raises(ValueError):
            fastmm.strassen_matmul(torch.zeros((4, 6)), torch.zeros((4, 6)))
        with pytest.raises(ValueError):
            fastmm.strassen_matmul(torch.zeros((4, 4)), torch.zeros((8, 8)))


class TestRecursionPolicy:
    @staticmethod
    def _counting_leaf(calls):
        def leaf(a, b):
            calls.append(a.shape[-1])
            return torch.matmul(a, b)
        return leaf

    def test_depth_cap_bounds_leaf_fanout(self):
        """levels=L does exactly 7^L leaf multiplies (n far above the
        crossover) — the depth cap, not n, stops the recursion."""
        a = _mat(16, seed=0)
        for levels, want in ((0, 1), (1, 7), (2, 49)):
            calls = []
            fastmm.strassen_matmul(a, a, levels=levels, crossover=1,
                                   leaf=self._counting_leaf(calls))
            assert len(calls) == want

    def test_crossover_fall_through_is_one_dense_call(self):
        """n <= crossover: exactly one leaf call on the untouched operands —
        below the crossover the fast route is the dense kernel."""
        a, b = _mat(48, seed=1), _mat(48, seed=2)
        calls = []
        got = fastmm.strassen_matmul(a, b, levels=3, crossover=48,
                                     leaf=self._counting_leaf(calls))
        assert calls == [48]
        assert torch.equal(got, torch.matmul(a, b))

    def test_plan_levels_mirrors_recursion(self):
        assert fastmm.plan_levels(509, levels=2, crossover=64) == 2
        assert fastmm.plan_levels(509, levels=5, crossover=64) == 3
        assert fastmm.plan_levels(64, levels=2, crossover=64) == 0
        assert fastmm.plan_levels(1, levels=4, crossover=1) == 0
        # Odd sizes halve via (n+1)//2, as the recursion pads them.
        assert fastmm.plan_levels(129, levels=3, crossover=33) == 2

    def test_error_budget_scales_per_level(self):
        r0, a0 = fastmm.error_budget(torch.float32, levels=0)
        r2, a2 = fastmm.error_budget(torch.float32, levels=2)
        assert (r2, a2) == (4 * r0, 4 * a0)
        assert fastmm.error_budget(torch.float32)[0] == \
            fastmm.DENSE_BUDGET["float32"][0]
        # bf16 at two levels: 0.6 (see the module docstring); f16 has no
        # entry and takes the float32 floors under its own eps term.
        assert fastmm.error_budget(torch.bfloat16, levels=2)[0] == \
            pytest.approx(0.6)
        eps16 = torch.finfo(torch.float16).eps
        r32, a32 = fastmm.DENSE_BUDGET["float32"]
        assert fastmm.error_budget(torch.float16) == (max(r32, 16 * eps16),
                                                      max(a32, 16 * eps16))


class TestAutotuneFastmm:
    def test_round_trip_and_reload(self, tmp_cache):
        autotune.record_fastmm(384, 1, leaf_blocks=(128, 128, 32),
                               dtype=torch.float32)
        assert autotune.fastmm_config(torch.float32) == (384, 1,
                                                         (128, 128, 32))
        autotune.clear_memory_cache()    # force a re-read from disk
        assert autotune.fastmm_config(torch.float32) == (384, 1,
                                                         (128, 128, 32))

    def test_dtype_agnostic_fallback_and_miss_defaults(self, tmp_cache):
        assert autotune.fastmm_config(torch.float32) == (
            autotune.DEFAULT_FASTMM_CROSSOVER,
            autotune.DEFAULT_FASTMM_LEVELS, None)
        autotune.record_fastmm(256, 3, dtype=None)
        assert autotune.fastmm_config(torch.bfloat16) == (256, 3, None)

    def test_corrupted_file_degrades_to_defaults(self, tmp_cache):
        tmp_cache.write_text("{this is not json")
        with pytest.warns(UserWarning, match="corrupted autotune cache"):
            assert autotune.fastmm_config(torch.float32) == (
                autotune.DEFAULT_FASTMM_CROSSOVER,
                autotune.DEFAULT_FASTMM_LEVELS, None)

    def test_record_repairs_corrupted_file(self, tmp_cache):
        tmp_cache.write_text("[1, 2, 3]")
        with pytest.warns(UserWarning, match="corrupted autotune cache"):
            autotune.record_fastmm(512, 2, dtype=torch.float32)
        autotune.clear_memory_cache()
        assert autotune.fastmm_config(torch.float32) == (512, 2, None)
        assert isinstance(json.loads(tmp_cache.read_text()), dict)

    def test_invalid_entries_filtered(self, tmp_cache):
        key = autotune._fastmm_key(torch.float32)
        tmp_cache.write_text(json.dumps({
            key: {"fastmm": [0, -1], "measured": False},
        }))
        assert autotune.fastmm_config(torch.float32) == (
            autotune.DEFAULT_FASTMM_CROSSOVER,
            autotune.DEFAULT_FASTMM_LEVELS, None)

    def test_record_validates_arguments(self, tmp_cache):
        with pytest.raises(ValueError):
            autotune.record_fastmm(0, 1)
        with pytest.raises(ValueError):
            autotune.record_fastmm(128, -1)
        with pytest.raises(ValueError):
            autotune.record_fastmm(128, 1, leaf_blocks=(128, 128))

    def test_record_bumps_cache_generation(self, tmp_cache):
        gen = autotune.cache_generation()
        autotune.record_fastmm(256, 2)
        assert autotune.cache_generation() > gen

    def test_modeled_sweep_records_provenance(self, tmp_cache):
        got = autotune.sweep_fastmm(torch.float32, measure=False)
        assert got == (autotune.DEFAULT_FASTMM_CROSSOVER,
                       autotune.DEFAULT_FASTMM_LEVELS)
        entry = json.loads(tmp_cache.read_text())[
            autotune._fastmm_key(torch.float32)]
        assert entry["measured"] is False

    @pytest.mark.parametrize("dtype,leaf", [
        (torch.float32, (128, 128, 128)),   # K step 128: no f32 K1
        (torch.bfloat16, (32, 32, 16)),     # K step 16: no bf16 K1
        (torch.float64, (128, 128, 32)),    # tile 128: no f64 K1
    ])
    def test_leaf_tiles_k1_does_not_run_are_refused(self, tmp_cache, dtype,
                                                    leaf):
        """A cached ``leaf_blocks`` that K1 does not instantiate for the
        entry's dtype would make every leaf raise: it is rejected when
        recorded, filtered when read from disk, and an agnostic entry
        holding it is skipped for that dtype."""
        with pytest.raises(ValueError, match="valid_blocks"):
            autotune.record_fastmm(256, 1, leaf_blocks=leaf, dtype=dtype)
        key = autotune._fastmm_key(dtype)
        tmp_cache.write_text(json.dumps({key: {
            "fastmm": [256, 1], "leaf_blocks": list(leaf),
            "measured": True}}))
        autotune.clear_memory_cache()
        assert autotune.fastmm_config(dtype) == (
            autotune.DEFAULT_FASTMM_CROSSOVER,
            autotune.DEFAULT_FASTMM_LEVELS, None)
        assert key not in autotune.load_cache()
        autotune.record_fastmm(300, 1, leaf_blocks=(64, 64, 32))
        want = (300, 1, (64, 64, 32)) if autotune.valid_blocks(
            (64, 64, 32), torch.empty((), dtype=dtype).element_size()) \
            else (autotune.DEFAULT_FASTMM_CROSSOVER,
                  autotune.DEFAULT_FASTMM_LEVELS, None)
        assert autotune.fastmm_config(dtype) == want


class TestChainFastPath:
    def test_fast_false_is_the_default_and_dense(self, tmp_cache):
        chain = ops.MatmulChain(96, torch.float32, device="cpu")
        assert chain.fast is False and chain.fast_levels == 0

    def test_fast_auto_follows_crossover(self, tmp_cache):
        """fast=None compares the chain's PADDED size (the buffer the
        squarings run on) against the crossover of its device type."""
        autotune.record_fastmm(64, 2, dtype=torch.float32, backend="cpu")
        chain = ops.MatmulChain(96, torch.float32, device="cpu", fast=None)
        assert chain.padded_n > 64 and chain.fast is True
        autotune.record_fastmm(512, 2, dtype=torch.float32, backend="cpu")
        chain = ops.MatmulChain(96, torch.float32, device="cpu", fast=None)
        assert chain.padded_n <= 512 and chain.fast is False

    def test_fast_chain_square_within_budget(self, tmp_cache):
        """A fast ``square`` is a fresh tensor: it never writes the spare
        buffer or its operand."""
        autotune.record_fastmm(16, 2, dtype=torch.float32, backend="cpu")
        chain = ops.MatmulChain(96, torch.float32, device="cpu", fast=True)
        a = _mat(96, seed=4)
        x = chain.pad(a)
        keep = x.clone()
        got = chain.unpad(chain.square(x))
        assert torch.equal(x, keep) and chain._spare is None
        want = a.double().numpy()
        _within(got, want @ want, levels=chain.fast_levels, n=96)


class TestEngineDispatch:
    def test_huge_n_bucket_takes_fastmm_route(self, tmp_cache):
        assert ROUTES == ("torch", "chain", "sharded", "fastmm", "evolve")
        autotune.record_fastmm(128, 2, backend="cpu")
        eng = MatFnEngine(device="cpu")
        assert eng.route_for(16, 1) == "torch"
        assert eng.route_for(96, 1) == "chain"      # above torch, below it
        assert eng.route_for(200, 1) == "fastmm"    # above the crossover
        assert eng.route_for(200, 4) == "fastmm"    # stacked buckets too

    def test_mid_process_retune_reroutes(self, tmp_cache):
        eng = MatFnEngine(device="cpu")
        assert eng.route_for(200, 1) == "chain"     # default crossover 1024
        autotune.record_fastmm(128, 2, backend="cpu")   # bumps the generation
        assert eng.route_for(200, 1) == "fastmm"

    def test_fastmm_bucket_executes_within_budget(self, tmp_cache):
        autotune.record_fastmm(64, 2, backend="cpu")
        eng = MatFnEngine(device="cpu")
        a = _mat(200, seed=7)
        p = 5
        idx = eng.submit("matpow", a, power=p)
        outs = eng.flush()
        assert eng.stats["routes"]["fastmm"] == 1
        _within(outs[idx],
                np.linalg.matrix_power(a.double().numpy(), p), levels=2,
                n=200, mults=_matpow_mults(p))


class TestAcceptance:
    """matpow via the fastmm route within the budget of its depth at n in
    {96, 200, 509}, depth <= 2, while every dense route keeps its bits."""

    @pytest.mark.parametrize("n", [96, 200, 509])
    def test_fastmm_within_budget_dense_bit_identical(self, tmp_cache, n):
        autotune.record_fastmm(64, 2, backend="cpu")  # engages at every n
        p = 7                                         # 2 squarings + 2 combines
        a = _mat(n, seed=n * 3 + 1)
        ref64 = np.linalg.matrix_power(a.double().numpy(), p)

        got_fast = matpow_binary(a, p, backend="cuda_fastmm")
        _within(got_fast, ref64, levels=2, n=n, mults=_matpow_mults(p))

        # Dense routes: untouched by the recorded fastmm config, and the
        # same-math entry points still agree bit for bit.
        want = matpow_binary(a, p)
        assert torch.equal(matpow_binary_traced(a, torch.tensor(p)), want)
        assert torch.equal(batched_matpow(a[None], p)[0], want)
        want_chain = matpow_binary(a, p, backend="cuda_chain")
        assert torch.equal(
            batched_matpow(a[None], p, backend="cuda_chain")[0], want_chain)


# -- the port's own ------------------------------------------------------------

class TestParityWithReference:
    """The same numpy operands through the reference's ``strassen_matmul``
    (Pallas leaves in interpret mode) and the port's (K1's plain version):
    each within ``error_budget(levels=...)`` of float64, and the two within
    that budget of each other (they sum in different orders)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("n,levels,crossover", [
        (17, 1, 8), (17, 2, 8), (33, 1, 16), (33, 2, 8), (64, 1, 16),
        (64, 2, 16)])
    def test_strassen_matmul_vs_reference(self, n, levels, crossover, dtype):
        from repro.kernels import fastmm as jfastmm
        ja, ta = pair(_np_mat(n, n), dtype)
        jb, tb = pair(_np_mat(n, n + 1), dtype)
        want = jfastmm.strassen_matmul(ja, jb, levels=levels,
                                       crossover=crossover, interpret=True)
        got = fastmm.strassen_matmul(ta, tb, levels=levels,
                                     crossover=crossover)
        used = fastmm.plan_levels(n, levels, crossover)
        assert used == jfastmm.plan_levels(n, levels, crossover) >= 1
        assert got.dtype == TORCH[dtype] and got.shape == (n, n)
        exact = as_f64(ta) @ as_f64(tb)
        _within(got, exact, TORCH[dtype], levels=used, n=n)
        _within(got, as_f64(want), TORCH[dtype], levels=used, n=n)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_fastmm_chain_vs_reference(self, tmp_cache, monkeypatch,
                                       tmp_path, dtype):
        """matpow on the Strassen chain, both packages under one config."""
        from repro.core import matpow_binary as jmatpow
        from repro.kernels import autotune as jautotune
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "j.json"))
        jautotune.clear_memory_cache()
        jautotune.record_fastmm(16, 2)
        autotune.record_fastmm(16, 2, backend="cpu")
        ja, ta = pair(_np_mat(40, 5), dtype)
        want = jmatpow(ja, 5, backend="pallas_fastmm_interpret")
        got = matpow_binary(ta, 5, backend="cuda_fastmm")
        jautotune.clear_memory_cache()
        _within(got, as_f64(want), TORCH[dtype], levels=2, n=40,
                mults=_matpow_mults(5))


class TestLeavesAreK1:
    def test_every_leaf_is_an_ops_matmul_launch(self, monkeypatch):
        """The leaves reach K1's wrapper, never ``torch.matmul`` — on the
        card that is the difference between the kernel and a cuBLAS
        fallback: with ``torch.matmul`` made to fail and K1's wrapper
        recording, a depth-2 square makes exactly 49 wrapper calls, each
        one stacked launch."""
        def no_library(*args, **kwargs):
            raise AssertionError("a Strassen leaf called torch.matmul")

        calls = []

        def k1(a, b, *, out_dtype, **blocks):
            calls.append(tuple(a.shape))
            return torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=out_dtype)

        monkeypatch.setattr(torch, "matmul", no_library)
        monkeypatch.setattr(ops, "matmul_cuda", k1)
        got = fastmm.strassen_square(torch.zeros((2, 64, 64)), levels=2,
                                     crossover=8)
        assert got.shape == (2, 64, 64)
        assert len(calls) == 49 and all(c[0] == 2 for c in calls)

    def test_halves_of_a_chain_pad_only_to_their_own_tiles(self,
                                                           monkeypatch):
        """A 3072 chain (n = 3000 padded) halves to 1536 and 768: each leaf
        is launched at its own size, a multiple of its own tile — 1536 is
        not padded up to 2048."""
        shapes = []

        def fake(a, b, *, block_m, block_n, block_k, out_dtype):
            shapes.append((a.shape[-2], a.shape[-1], block_m, block_k))
            return torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=out_dtype)

        monkeypatch.setattr(ops, "matmul_cuda", fake)
        chain = ops.MatmulChain(3000, torch.float32, device="cpu", fast=True)
        assert chain.padded_n == 3072
        x = torch.zeros((3072, 3072))
        for levels, half in ((1, 1536), (2, 768)):
            shapes.clear()
            fastmm.strassen_square(x, levels=levels, crossover=512)
            assert len(shapes) == 7 ** levels
            assert {(m, k) for m, k, _, _ in shapes} == {(half, half)}
            assert all(half % bm == 0 and half % bk == 0
                       for _, _, bm, bk in shapes)


class TestStrassenProperties:
    """Twins of tests/test_chains_property.py's Strassen properties: at any
    (n, depth) the route lands inside ``error_budget`` for the depth it
    recursed, and a squaring chain on it within the budget scaled by its
    multiplies."""

    @settings(max_examples=12, deadline=None)
    @given(st.integers(min_value=1, max_value=257),
           st.integers(min_value=0, max_value=3))
    def test_strassen_square_within_budget_any_depth(self, n, depth):
        a = _mat(n, seed=n * 43 + depth)
        got = fastmm.strassen_square(a, levels=depth, crossover=8)
        used = fastmm.plan_levels(n, levels=depth, crossover=8)
        assert used <= depth
        a64 = a.double().numpy()
        _within(got, a64 @ a64, levels=used, n=n)

    @settings(max_examples=12, deadline=None)
    @given(st.integers(min_value=2, max_value=129),
           st.integers(min_value=1, max_value=4))
    def test_strassen_squaring_chain_within_budget(self, n, k):
        a = _mat(n, seed=n * 11 + k)
        x = a
        for _ in range(k):
            x = fastmm.strassen_square(x, levels=2, crossover=8)
        used = fastmm.plan_levels(n, levels=2, crossover=8)
        _within(x, np.linalg.matrix_power(a.double().numpy(), 2 ** k),
                levels=used, n=n, mults=k)
