"""The port's matrix-function serving engine (``repro_torch.serve.matfn``):
batched-chain numerics, request bucketing, callable-cache reuse, and
heterogeneous dispatch — the reference's tests/test_matfn.py on CPU tensors
(``device="cpu"``: the kernels' plain versions), plus the port's own
contracts:

  * stacked matpow at p in {1, 2, 7, 96} against a per-matrix loop, f32 and
    bf16, non-divisible n, through the stacked chain (``"cuda_chain"``);
  * the single-pad invariant and the two-buffer donation of the stacked
    chain;
  * engine answers in submission order across mixed (op, n, dtype, power)
    traffic, held to per-matrix calls under ``error_budget`` (the port
    does not claim bucket-vs-per-matrix bits: see
    ``_torch_parity.assert_bucket_answer``);
  * bucket policy (power-of-two batch padding, max_batch chunking) and the
    callable cache (one build per bucket shape, hits afterwards);
  * dispatch thresholds from the tuning cache's ``dispatch`` namespace
    (tiny -> torch, mid -> chain), and the routes not ported yet —
    ``fastmm`` above the Strassen crossover, the ``markov`` op, ``sharded``
    — refused at ``submit`` with nothing admitted;
  * the device rule (cuda by default, no quiet moves) and the engine's own
    copy of each operand.
"""

import inspect

import numpy as np
import pytest
import torch

from _torch_parity import assert_bucket_answer, matpow_mults, per_matrix

from repro_torch.core import (BatchedMatmulChain, batched_expm,
                              batched_matpow, expm, matpow_binary)
from repro_torch.kernels import autotune, ops
from repro_torch.serve.matfn import (NOT_PORTED, ROUTES, MatFnEngine,
                                     MatFnRequest, bucket_batch)
from repro_torch.serve.scheduler import ManualClock

CHAIN = "cuda_chain"
TIMEOUT = 30.0   # real-time backstop on future waits; never load-bearing


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def _stack(b, n, seed=0, dtype=torch.float32, scale=None):
    rng = np.random.default_rng(seed)
    scale = scale if scale is not None else 0.5 / np.sqrt(n)
    return torch.tensor(rng.standard_normal((b, n, n)) * scale, dtype=dtype)


def _ref_pow(a, p):
    return np.linalg.matrix_power(a.double().numpy(), p)


class TestBatchedChainNumerics:
    @pytest.mark.parametrize("p", [1, 2, 7, 96])
    def test_stacked_matpow_vs_per_matrix_loop(self, p):
        """The stacked chain matches a loop of per-matrix chains."""
        a = _stack(3, 96, seed=p)
        got = batched_matpow(a, p, backend=CHAIN)
        for i in range(a.shape[0]):
            want = matpow_binary(a[i], p, backend=CHAIN)
            assert_bucket_answer(got[i], want, mults=matpow_mults(p))
            np.testing.assert_allclose(got[i].numpy(), _ref_pow(a[i], p),
                                       rtol=5e-3, atol=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_mixed_dtypes(self, dtype):
        a = _stack(2, 64, seed=5, dtype=dtype)
        got = batched_matpow(a, 7, backend=CHAIN).float().numpy()
        for i in range(2):
            np.testing.assert_allclose(
                got[i], _ref_pow(a[i].float(), 7),
                rtol=5e-2 if dtype == torch.bfloat16 else 2e-3, atol=1e-2)

    @pytest.mark.parametrize("n", [67, 200])
    def test_non_divisible_n(self, n):
        """Sizes that force real padding (not multiples of any block)."""
        a = _stack(2, n, seed=n)
        got = batched_matpow(a, 7, backend=CHAIN)
        for i in range(2):
            np.testing.assert_allclose(got[i].numpy(), _ref_pow(a[i], 7),
                                       rtol=5e-3, atol=1e-5)

    def test_xla_backend_matches_per_matrix(self):
        """The ``"torch"`` backend (the reference's ``"xla"``)."""
        a = _stack(4, 24, seed=9)
        got = batched_matpow(a, 12)
        for i in range(4):
            assert_bucket_answer(got[i], matpow_binary(a[i], 12),
                                 mults=matpow_mults(12))

    def test_p0_identity_contract(self):
        a = _stack(3, 20, seed=1)
        for backend in ("torch", CHAIN):
            got = batched_matpow(a, 0, backend=backend)
            assert torch.equal(got, torch.eye(20).expand(a.shape))

    def test_batched_expm_matches_per_matrix(self):
        a = _stack(3, 16, seed=2, scale=0.4)
        got = batched_expm(a)
        for i in range(3):
            np.testing.assert_allclose(got[i].numpy(), expm(a[i]).numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_rejections(self):
        with pytest.raises(ValueError):
            batched_matpow(torch.ones((4, 4)), 2)         # not a stack
        with pytest.raises(ValueError):
            batched_matpow(torch.ones((2, 3, 4)), 2)      # not square
        with pytest.raises(TypeError):
            batched_matpow(_stack(2, 8), torch.tensor(3))  # tensor power
        with pytest.raises(ValueError):
            batched_matpow(_stack(2, 8), -1)              # negative power
        with pytest.raises(ValueError):
            batched_expm(torch.ones((4, 4)))              # not a stack


class TestBatchedChainStructure:
    def test_single_pad_invariant(self, monkeypatch):
        """ONE ops.pad_to_blocks call for the whole stacked chain."""
        calls = []
        real = ops.pad_to_blocks

        def counting(a, bm, bn):
            calls.append(tuple(a.shape))
            return real(a, bm, bn)

        monkeypatch.setattr(ops, "pad_to_blocks", counting)
        batched_matpow(_stack(3, 100, seed=4), 9, backend=CHAIN)
        assert len(calls) == 1
        assert calls[0][0] == 3                      # padded as ONE stack

    def test_eager_square_donates_stack(self):
        """Donation, the PyTorch form: the chain owns two buffers and
        ping-pongs — the squaring after next writes into the consumed
        operand's buffer, one launch for the whole stack each time."""
        chain = BatchedMatmulChain(2, 128, torch.float32, device="cpu")
        a = _stack(2, 128, seed=6, scale=1.0)
        want = a.numpy() @ a.numpy()
        x = chain.pad(a)
        y = chain.square(x)
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-4, atol=1e-3)
        z = chain.square(y)
        assert z.data_ptr() == x.data_ptr()          # x was consumed
        assert x.data_ptr() != a.data_ptr()          # never the caller's

    def test_square_matches_ref_per_matrix(self):
        chain = BatchedMatmulChain(2, 128, torch.float32, device="cpu",
                                   donate=False)
        x = _stack(2, 128, seed=7, scale=1.0)
        keep = x.clone()
        y = chain.square(x)
        for i in range(2):
            np.testing.assert_allclose(
                y[i].numpy(), x[i].numpy() @ x[i].numpy(),
                rtol=1e-4, atol=1e-3)
        assert torch.equal(x, keep)

    def test_caller_buffer_never_consumed(self):
        a = _stack(2, 128, seed=8)                   # block-divisible: no pad
        keep = a.clone()
        out = batched_matpow(a, 4, backend=CHAIN)
        assert torch.equal(a, keep)
        np.testing.assert_allclose(out[0].numpy(), _ref_pow(a[0], 4),
                                   rtol=2e-3, atol=1e-5)

    def test_constructor_rejections(self):
        with pytest.raises(ValueError):
            BatchedMatmulChain(0, 16, torch.float32)
        with pytest.raises(ValueError):
            BatchedMatmulChain(2, 0, torch.float32)
        chain = BatchedMatmulChain(2, 16, torch.float32, device="cpu")
        with pytest.raises(ValueError):
            chain.pad(torch.ones((3, 16, 16)))       # wrong batch
        with pytest.raises(ValueError):
            chain.pad(torch.ones((16, 16)))          # not a stack


class TestBucketPolicy:
    def test_bucket_batch_powers_of_two(self):
        assert [bucket_batch(b) for b in (1, 2, 3, 5, 8, 9, 33)] == \
            [1, 2, 4, 8, 8, 16, 64]
        assert bucket_batch(100, max_batch=64) == 64
        with pytest.raises(ValueError):
            bucket_batch(0)

    def test_request_validation(self):
        with pytest.raises(ValueError):
            MatFnRequest("cholesky", torch.eye(4))
        with pytest.raises(ValueError):
            MatFnRequest("matpow", torch.ones((3, 4)), 2)
        with pytest.raises(ValueError):
            MatFnRequest("matpow", torch.ones((0, 0)), 2)
        with pytest.raises(TypeError):
            MatFnRequest("matpow", torch.eye(4), torch.tensor(2))
        with pytest.raises(TypeError):
            MatFnRequest("matpow", torch.eye(4), True)
        with pytest.raises(ValueError):
            MatFnRequest("matpow", torch.eye(4), -1)
        with pytest.raises(TypeError):
            MatFnRequest("matpow", torch.eye(4, dtype=torch.int32), 2)

    def test_bucket_key_groups_by_op_n_dtype_power(self):
        k1 = MatFnRequest("matpow", torch.eye(8), 3).bucket_key()
        k2 = MatFnRequest("matpow", torch.eye(8), 3).bucket_key()
        k3 = MatFnRequest("matpow", torch.eye(8), 4).bucket_key()
        k4 = MatFnRequest("matpow", torch.eye(8, dtype=torch.bfloat16),
                          3).bucket_key()
        k5 = MatFnRequest("expm", torch.eye(8)).bucket_key()
        assert k1 == k2 == ("matpow", 8, "float32", 3)
        assert len({k1, k3, k4, k5}) == 4
        assert k4[2] == "bfloat16" and k5[3] == -1


class TestEngine:
    def test_results_match_per_matrix_and_in_order(self):
        """Mixed traffic: answers in ticket order, each within
        error_budget of its per-matrix call."""
        rng = np.random.default_rng(0)
        eng = MatFnEngine(device="cpu")
        work = []
        for i in range(12):
            n = int(rng.choice((8, 12, 16)))
            a = torch.tensor(rng.standard_normal((n, n)) * 0.3,
                             dtype=torch.float32)
            if i % 4 == 3:
                work.append(("expm", a, 1))
            else:
                work.append(("matpow", a, int(rng.choice((2, 7)))))
        tickets = [eng.submit(op, a, power=p) for op, a, p in work]
        results = eng.flush()
        assert tickets == list(range(12))
        for (op, a, p), t in zip(work, tickets):
            assert_bucket_answer(results[t], per_matrix(op, a, p))

    def test_bucketing_counts(self):
        eng = MatFnEngine(device="cpu")
        a8 = _stack(5, 8, seed=1)
        for i in range(5):
            eng.submit("matpow", a8[i], power=7)
        eng.submit("matpow", _stack(1, 12, seed=2)[0], power=7)
        eng.flush()
        # two buckets: (matpow, 8, f32, 7) x5 padded to 8, and one n=12
        assert eng.stats["buckets"] == 2
        assert eng.stats["padded_slots"] == 3
        assert eng.stats["requests"] == 6

    def test_numpy_f64_operand_shares_the_f64_bucket(self):
        """A numpy operand is copied onto the engine's device in its own
        dtype: float64 numpy shares a bucket — and a callable — with the
        float64 tensor of the same values. (The reference canonicalizes
        numpy f64 to f32 under JAX's disabled x64; PyTorch has no such
        switch, so the port keeps the caller's precision.)"""
        rng = np.random.default_rng(11)
        host = rng.standard_normal((8, 8))             # np.float64
        eng = MatFnEngine(device="cpu")
        eng.submit("matpow", host, power=3)
        eng.submit("matpow", torch.tensor(host), power=3)
        res = eng.flush()
        assert eng.stats["buckets"] == 1
        assert res[0].dtype == torch.float64
        assert torch.equal(res[0], res[1])

    def test_mixed_dtypes_split_buckets(self):
        eng = MatFnEngine(device="cpu")
        eng.submit("matpow", _stack(1, 8, dtype=torch.float32)[0], power=3)
        eng.submit("matpow", _stack(1, 8, dtype=torch.bfloat16)[0], power=3)
        res = eng.flush()
        assert eng.stats["buckets"] == 2
        assert res[0].dtype == torch.float32
        assert res[1].dtype == torch.bfloat16

    def test_executable_cache_reused_across_flushes(self):
        eng = MatFnEngine(device="cpu")
        a = _stack(3, 8, seed=3)
        for i in range(3):
            eng.submit("matpow", a[i], power=5)
        eng.flush()
        compiles = eng.stats["compiles"]
        for i in range(3):
            eng.submit("matpow", a[i], power=5)
        eng.flush()
        assert eng.stats["compiles"] == compiles     # no new callable
        assert eng.stats["cache_hits"] >= 1

    def test_max_batch_chunking(self):
        eng = MatFnEngine(device="cpu", max_batch=4)
        a = _stack(10, 8, seed=4)
        for i in range(10):
            eng.submit("matpow", a[i], power=3)
        res = eng.flush()
        assert eng.stats["buckets"] == 3             # 4 + 4 + 2
        for i in range(10):
            assert_bucket_answer(res[i], matpow_binary(a[i], 3))

    def test_chain_route_numerics(self, tmp_cache):
        """Force mid-size traffic onto the stacked kernel chain."""
        autotune.record_dispatch_thresholds(8, 1 << 30, backend="cpu")
        eng = MatFnEngine(device="cpu")
        assert eng.thresholds == (8, 1 << 30)
        a = _stack(3, 40, seed=5)
        for i in range(3):
            eng.submit("matpow", a[i], power=7)
        res = eng.flush()
        assert eng.stats["routes"]["chain"] == 1
        for i in range(3):
            np.testing.assert_allclose(res[i].numpy(), _ref_pow(a[i], 7),
                                       rtol=2e-3, atol=1e-5)

    def test_p0_and_convenience_api(self):
        eng = MatFnEngine(device="cpu")
        a = _stack(1, 8, seed=6)[0]
        assert torch.equal(eng.matpow(a, 0), torch.eye(8))
        assert_bucket_answer(eng.expm(a), expm(a))

    def test_profile_mode_records_bucket_seconds(self):
        eng = MatFnEngine(device="cpu", profile=True)
        eng.submit("matpow", _stack(1, 8)[0], power=3)
        eng.flush()
        rows = eng.stats["last_flush"]
        assert len(rows) == 1 and rows[0]["seconds"] > 0


class TestDeviceAndOwnership:
    def test_default_device_is_the_gpu_or_an_error(self):
        if torch.cuda.device_count():
            assert MatFnEngine().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                MatFnEngine()

    def test_reference_keywords_are_gone(self):
        params = inspect.signature(MatFnEngine).parameters
        assert "device" in params
        assert "interpret" not in params and "mesh" not in params

    def test_tensor_on_another_device_is_refused(self):
        eng = MatFnEngine(device="cpu")
        with pytest.raises(ValueError, match="nothing is moved"):
            eng.submit("matpow", torch.empty((4, 4), device="meta"), power=2)
        assert eng.stats["requests"] == 0

    @pytest.mark.parametrize("daemon", [False, True])
    def test_caller_writes_after_submit_do_not_change_the_answer(
            self, daemon):
        """The engine takes its own copy at submit: zeroing the caller's
        tensor right after leaves the answer equal to A^p."""
        a = _stack(1, 16, seed=12)[0]
        want = matpow_binary(a.clone(), 7)
        eng = MatFnEngine(device="cpu", clock=ManualClock(),
                          max_delay_ms=10.0)
        if daemon:
            with eng:
                fut = eng.submit("matpow", a, power=7)
                a.zero_()
                eng.kick()
                got = fut.result(timeout=TIMEOUT)
        else:
            eng.submit("matpow", a, power=7)
            a.zero_()
            (got,) = eng.flush()
        assert_bucket_answer(got, want, mults=matpow_mults(7))
        assert float(got.abs().max()) > 0.0


class TestHeterogeneousDispatch:
    def test_default_thresholds(self):
        assert autotune.DEFAULT_DISPATCH_THRESHOLDS == (64, 4096)
        assert autotune.DEFAULT_FASTMM_CROSSOVER == 1024
        assert ROUTES == ("torch", "chain", "sharded", "fastmm", "evolve")

    def test_cache_round_trip(self, tmp_cache):
        autotune.record_dispatch_thresholds(32, 2048, dtype=torch.float32)
        assert autotune.dispatch_thresholds(dtype=torch.float32) == \
            (32, 2048)
        # dtype-agnostic fallback
        assert autotune.dispatch_thresholds(dtype=torch.bfloat16) == \
            autotune.DEFAULT_DISPATCH_THRESHOLDS
        autotune.clear_memory_cache()                # survives reload
        assert autotune.dispatch_thresholds(dtype=torch.float32) == \
            (32, 2048)

    def test_record_rejects_descending(self):
        with pytest.raises(ValueError):
            autotune.record_dispatch_thresholds(4096, 64)
        with pytest.raises(ValueError):
            autotune.record_dispatch_thresholds(0, 64)

    def test_thresholds_never_cross_namespaces(self, tmp_cache):
        """A dispatch entry must not answer square_panel tier lookups."""
        autotune.record_dispatch_thresholds(32, 2048)
        assert autotune.square_tiers() == autotune.DEFAULT_SQUARE_TIERS

    def test_routing_table(self, tmp_cache):
        autotune.record_dispatch_thresholds(16, 256, backend="cpu")
        eng = MatFnEngine(device="cpu")
        assert eng.route_for(8, 4) == "torch"        # tiny -> cuBLAS / CPU
        assert eng.route_for(16, 1) == "torch"
        assert eng.route_for(64, 4) == "chain"       # mid -> kernel chain
        assert eng.route_for(256, 1) == "chain"      # no mesh -> no sharding
        assert eng.route_for(1024, 1) == "chain"
        assert eng.route_for(1025, 1) == "fastmm"    # above the crossover

    def test_sharded_route_end_to_end(self, tmp_cache):
        """The sharded route needs a mesh, which the port's engine does not
        take: no bucket ever routes there, and a callable for it is
        refused naming the ROADMAP item."""
        autotune.record_dispatch_thresholds(8, 32, backend="cpu")
        eng = MatFnEngine(device="cpu")
        assert {eng.route_for(n, 1) for n in (8, 48, 512)} == \
            {"torch", "chain"}
        a = _stack(1, 48, seed=7)[0]
        got = eng.matpow(a, 7)
        assert eng.stats["routes"]["sharded"] == 0
        assert eng.stats["routes"]["chain"] == 1
        np.testing.assert_allclose(got.numpy(), _ref_pow(a, 7),
                                   rtol=2e-3, atol=1e-5)
        with pytest.raises(ValueError, match="unknown matmul backend.*"
                           "item 7"):
            eng._executable("matpow", "sharded", 1, 48, "float32", 7)
        assert "item 7" in NOT_PORTED["sharded"]

    def test_explicit_thresholds_override_cache(self, tmp_cache):
        autotune.record_dispatch_thresholds(16, 256, backend="cpu")
        eng = MatFnEngine(device="cpu", thresholds=(4, 1 << 20))
        assert eng.route_for(8, 2) == "chain"

    def test_per_dtype_thresholds_respected(self, tmp_cache):
        """A dtype-specific dispatch entry steers routing (a bf16
        crossover may differ from f32)."""
        autotune.record_dispatch_thresholds(16, 1 << 20,
                                            dtype=torch.bfloat16,
                                            backend="cpu")
        eng = MatFnEngine(device="cpu")
        assert eng.route_for(32, 2, dtype=torch.bfloat16) == "chain"
        assert eng.route_for(32, 2, dtype="bfloat16") == "chain"
        assert eng.route_for(32, 2, dtype=torch.float32) == "torch"
        assert eng.thresholds == autotune.DEFAULT_DISPATCH_THRESHOLDS
        # and end to end: the bucket dtype picks the entry
        a = _stack(2, 32, seed=9, dtype=torch.bfloat16)
        eng2 = MatFnEngine(device="cpu")
        for i in range(2):
            eng2.submit("matpow", a[i], power=3)
        eng2.flush()
        assert eng2.stats["routes"]["chain"] == 1


class TestRefusedRoutes:
    """Routes whose slice has not landed are refused at ``submit`` —
    exactly, since a request's route depends only on (op, n, dtype): no
    ticket or future is made and nothing is admitted."""

    FAST_N = autotune.DEFAULT_FASTMM_CROSSOVER + 1

    @staticmethod
    def _nothing_admitted(eng):
        snap = eng.stats()
        assert snap["requests"] == 0 and snap["open_buckets"] == 0
        assert all(row["submitted"] == 0 and row["queue_depth"] == 0
                   for row in snap["lanes"].values())

    @pytest.mark.parametrize("daemon", [False, True])
    def test_fastmm_refused_at_submit(self, daemon):
        eng = MatFnEngine(device="cpu", clock=ManualClock(),
                          max_delay_ms=10.0)
        big = torch.zeros((self.FAST_N, self.FAST_N))
        if daemon:
            eng.start()
        with pytest.raises(ValueError, match="unknown matmul backend for "
                           "'fastmm'.*ROADMAP queue 1 item 4"):
            eng.submit("matpow", big, power=3)
        with pytest.raises(ValueError, match="item 4"):
            eng.submit("expm", big)
        self._nothing_admitted(eng)
        if not daemon:
            assert eng.flush() == []
        eng.close()

    def test_fastmm_follows_the_thresholds(self):
        """Below cpu_max_n every size takes the torch route, so the refusal
        moves with the thresholds: it is decided by the route, not n."""
        eng = MatFnEngine(device="cpu", thresholds=(2048, 4096))
        (got,) = [eng.submit("matpow", torch.eye(self.FAST_N), power=2)]
        assert got == 0
        assert torch.equal(eng.flush()[0], torch.eye(self.FAST_N))
        assert eng.stats["routes"]["torch"] == 1

    @pytest.mark.parametrize("daemon", [False, True])
    def test_markov_refused_at_submit(self, daemon):
        eng = MatFnEngine(device="cpu", clock=ManualClock(),
                          max_delay_ms=10.0)
        p = torch.full((8, 8), 1.0 / 8)
        if daemon:
            eng.start()
        with pytest.raises(ValueError, match="unknown matmul backend for "
                           "'markov'.*ROADMAP queue 1 item 5"):
            eng.submit("markov", p)
        with pytest.raises(ValueError, match="item 5"):
            eng.warm("markov", 8)
        self._nothing_admitted(eng)
        eng.close()

    def test_warm_refuses_fastmm(self):
        eng = MatFnEngine(device="cpu")
        with pytest.raises(ValueError, match="item 4"):
            eng.warm("matpow", self.FAST_N, power=2, batches=(1,))
        assert eng.stats["buckets"] == 0
