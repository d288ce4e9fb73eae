"""The port's Markov workloads (``repro_torch.core.markov``) and the
``dense_matmul`` they run on, on the CPU.

The reference's tests/test_markov.py on CPU tensors (the chain's kernels in
their plain versions): ``steady_state``'s pi is the dominant left
eigenvector, its squaring loop has the bits of ``matpow_binary(p, 2**k)``
at equal squaring counts on the same backend, ``evolve_distributions``
matches a per-step loop and its big-B dense fallback, ``validate_stochastic``
rejects and repairs, and ``op="markov"`` rides the engine in synchronous and
daemon modes with its steady-state and ``evolve`` routes. Then the port's
own:

  * parity with the reference on the same numpy inputs: ``steady_state``
    (``pi``, ``squarings``, ``residual``) on the torch / xla and chain
    routes, ``evolve_distributions`` with B <= n, B > n (the dense
    fallback), one distribution, and n = 45, which the chain pads — held
    to the reference under ``error_budget(float32, n, mults)``, mults the
    multiplies the answer went through;
  * padded rows and columns never leak into ``pi``, ``residual`` or the
    evolved rows;
  * ``dense_matmul`` against the reference's, and its gradient.
"""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from _torch_parity import as_f64, assert_close

from repro_torch.core import (SteadyStateResult, evolve_distributions,
                              markov_power, matpow_binary, steady_state,
                              validate_stochastic)
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import matmul_kernels as K
from repro_torch.serve.matfn import MatFnEngine
from repro_torch.serve.scheduler import ManualClock

pytestmark = pytest.mark.timeout(300)

SET = dict(max_examples=15, deadline=None)
TIMEOUT = 30.0
CHAIN = "cuda_chain"
#: torch/chain crossover of the engine tests: n <= 16 -> torch.
THRESHOLDS = (16, 1 << 30)


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    autotune.clear_memory_cache()
    yield path
    autotune.clear_memory_cache()


def _np_stochastic(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) + 0.05        # strictly positive -> ergodic
    return m / m.sum(axis=1, keepdims=True)


def _stochastic(n, seed, dtype=torch.float32):
    return torch.tensor(_np_stochastic(n, seed), dtype=dtype)


def _eig_pi(p):
    """float64 oracle: the left eigenvector of the dominant eigenvalue 1
    (unique for a strictly positive P), normalised to a distribution."""
    w, v = np.linalg.eig(p.double().numpy().T)
    pi = np.abs(v[:, int(np.argmax(w.real))].real)
    return pi / pi.sum()


class TestValidateStochastic:
    def test_valid_matrix_passes_through(self):
        p = _stochastic(6, 0)
        assert torch.equal(validate_stochastic(p), p)

    def test_rejects_negative_entries(self):
        p = _stochastic(4, 1)
        p[0, 0] -= 0.5
        p[0, 1] += 0.5
        with pytest.raises(ValueError, match="non-negative"):
            validate_stochastic(p)

    def test_rejects_bad_row_sums(self):
        p = _stochastic(4, 2) * 1.5
        with pytest.raises(ValueError, match="sum to 1"):
            validate_stochastic(p)

    def test_renormalize_repairs_row_sums(self):
        p = _stochastic(5, 3) * 1.7
        fixed = validate_stochastic(p, renormalize=True)
        np.testing.assert_allclose(fixed.sum(dim=1).numpy(), 1.0, atol=1e-6)

    def test_renormalize_rejects_nonpositive_rows(self):
        p = torch.zeros((3, 3))
        p[1:] = _stochastic(3, 4)[1:]
        with pytest.raises(ValueError, match="renormalize"):
            validate_stochastic(p, renormalize=True)

    def test_rejects_non_square(self):
        with pytest.raises(ValueError, match="square"):
            validate_stochastic(torch.ones((3, 4)) / 4)

    def test_stacks_are_gated_row_by_row(self):
        """The reference's traced-input case has no counterpart (the port
        runs eagerly); its twin checks the (..., n, n) stack form: one bad
        row anywhere in the stack is caught."""
        stack = torch.stack([_stochastic(4, 5), _stochastic(4, 6)])
        assert torch.equal(validate_stochastic(stack), stack)
        stack[1, 2] *= 1.5
        with pytest.raises(ValueError, match="sum to 1"):
            validate_stochastic(stack)


class TestSteadyState:
    @given(st.integers(2, 12), st.integers(0, 1000))
    @settings(**SET)
    def test_pi_is_dominant_left_eigenvector(self, n, seed):
        p = _stochastic(n, seed)
        res = steady_state(p, tol=1e-7)
        np.testing.assert_allclose(res.pi.double().numpy(), _eig_pi(p),
                                   atol=5e-5)
        drift = (res.pi @ p - res.pi).abs().max().item()   # pi P = pi
        assert drift < 5e-6

    def test_early_exit_beats_fixed_policy(self):
        res = steady_state(_stochastic(16, 7), tol=1e-6)
        assert 0 < int(res.squarings) < 20       # the gated win
        assert float(res.residual) <= 1e-6       # exited by convergence

    @pytest.mark.parametrize("backend", ["torch", CHAIN])
    def test_bit_identical_to_matpow_at_equal_squarings(self, backend):
        p = _stochastic(24, 11)
        res = steady_state(p, tol=1e-6, backend=backend)
        k = int(res.squarings)
        want = matpow_binary(p, 1 << k, backend=backend)
        assert torch.equal(res.matrix, want)

    def test_cap_exit_reports_residual_above_tol(self):
        res = steady_state(_stochastic(8, 13), tol=0.0, max_squarings=3)
        assert int(res.squarings) == 3
        assert float(res.residual) > 0.0         # the cap, not convergence

    def test_single_state_chain(self):
        res = steady_state(torch.ones((1, 1)))
        assert res.pi.tolist() == [1.0]

    def test_rejects_batches(self):
        with pytest.raises(ValueError, match="one"):
            steady_state(torch.stack([_stochastic(4, 0), _stochastic(4, 1)]))

    def test_result_is_named_tuple_pytree(self):
        from torch.utils import _pytree
        res = steady_state(_stochastic(4, 17))
        assert isinstance(res, SteadyStateResult)
        assert len(_pytree.tree_leaves(res)) == 4
        assert res.squarings.dtype == torch.int32 and res.squarings.ndim == 0
        assert res.residual.dtype == torch.float32 and res.residual.ndim == 0

    def test_markov_power_matches_numpy(self):
        p = _stochastic(6, 19)
        got = markov_power(p, 13).numpy()
        ref = np.linalg.matrix_power(p.double().numpy(), 13)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


class TestEvolveDistributions:
    @given(st.integers(0, 40), st.integers(1, 6), st.integers(0, 1000))
    @settings(**SET)
    def test_matches_dense_step_loop(self, steps, b, seed):
        n = 7
        p = _stochastic(n, seed)
        d = np.random.default_rng(seed + 1).random((b, n)).astype(np.float32)
        d /= d.sum(axis=1, keepdims=True)
        got = evolve_distributions(torch.from_numpy(d), p, steps).numpy()
        ref = d.astype(np.float64)
        p64 = p.double().numpy()
        for _ in range(steps):
            ref = ref @ p64
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=1e-5)

    def test_single_distribution_keeps_shape(self):
        p = _stochastic(5, 3)
        out = evolve_distributions(torch.ones((5,)) / 5, p, 9)
        assert out.shape == (5,)
        np.testing.assert_allclose(float(out.sum()), 1.0, atol=1e-5)

    def test_zero_steps_is_identity(self):
        p = _stochastic(4, 5)
        d = torch.eye(4)[:2]
        out = evolve_distributions(d, p, 0)
        assert torch.equal(out, d) and out.data_ptr() != d.data_ptr()

    def test_dense_fallback_agrees(self, tmp_cache):
        # Forcing the big-B regime (threshold ~0) must change only the
        # schedule of multiplies, not the answer beyond fp32 noise.
        p = _stochastic(8, 7)
        d = torch.tensor(np.random.default_rng(8).random((16, 8)),
                         dtype=torch.float32)
        via_evolve = evolve_distributions(d, p, 21, dense_threshold=1e9)
        via_dense = evolve_distributions(d, p, 21, dense_threshold=1e-9)
        np.testing.assert_allclose(via_evolve.numpy(), via_dense.numpy(),
                                   rtol=1e-5, atol=1e-6)

    def test_rejects_non_static_steps(self):
        p = _stochastic(4, 9)
        with pytest.raises(TypeError, match="static"):
            evolve_distributions(torch.ones((4,)) / 4, p, torch.tensor(3))
        with pytest.raises(TypeError, match="static"):
            evolve_distributions(torch.ones((4,)) / 4, p, True)
        with pytest.raises(ValueError, match=">= 0"):
            evolve_distributions(torch.ones((4,)) / 4, p, -1)

    def test_rejects_mismatched_n(self):
        with pytest.raises(ValueError, match="feature dim"):
            evolve_distributions(torch.ones((5,)) / 5, _stochastic(4, 0), 2)

    def test_autotuned_threshold_round_trip(self, tmp_cache):
        assert autotune.markov_evolve_threshold(torch.float32) == \
            autotune.DEFAULT_MARKOV_EVOLVE_THRESHOLD == 1.0
        autotune.record_markov_evolve_threshold(2.5, dtype=torch.float32)
        assert autotune.markov_evolve_threshold(torch.float32) == 2.5
        with pytest.raises(ValueError):
            autotune.record_markov_evolve_threshold(0.0)


class TestEngineMarkov:
    @staticmethod
    def _engine(clock=None, **kw):
        kw.setdefault("thresholds", THRESHOLDS)
        kw.setdefault("max_batch", 16)
        return MatFnEngine(device="cpu", clock=clock, **kw)

    def test_sync_steady_state_bit_identical_to_core(self, tmp_cache):
        eng = self._engine()
        p = _stochastic(8, 21)
        got = eng.steady_state(p)
        want = steady_state(p, validate=False)
        assert torch.equal(got.pi, want.pi)
        assert torch.equal(got.matrix, want.matrix)
        assert int(got.squarings) == int(want.squarings)

    def test_sync_bucket_keeps_per_member_convergence(self, tmp_cache):
        # Three same-shape steady-state queries share one bucket, and each
        # member keeps its OWN squaring count and per-matrix answer.
        eng = self._engine()
        mats = [_stochastic(8, s) for s in (31, 32, 33)]
        idx = [eng.submit("markov", p) for p in mats]
        results = eng.flush()
        assert eng.stats()["buckets"] == 1
        for i, p in zip(idx, mats):
            want = steady_state(p, validate=False)
            got = results[i]
            assert torch.equal(got.pi, want.pi)
            assert int(got.squarings) == int(want.squarings)

    def test_sync_evolve_matches_core(self, tmp_cache):
        eng = self._engine()
        p = _stochastic(8, 41)
        d = torch.tensor(np.random.default_rng(42).random((4, 8)),
                         dtype=torch.float32)
        got = eng.evolve(d, p, 17)
        want = evolve_distributions(d, p, 17, validate=False)
        assert torch.equal(got, want)

    def test_steady_state_routes_to_chain_above_threshold(self, tmp_cache):
        eng = self._engine()
        p = _stochastic(32, 43)              # 32 > cpu_max_n = 16 -> chain
        got = eng.steady_state(p)
        assert eng.stats()["routes"]["chain"] == 1
        want = steady_state(p, validate=False, backend=CHAIN)
        assert torch.equal(got.matrix, want.matrix)

    def test_warm_precompiles_steady_state_class(self, tmp_cache):
        eng = self._engine()
        eng.warm("markov", 8)
        compiles = eng.stats()["compiles"]
        eng.steady_state(_stochastic(8, 47))
        assert eng.stats()["compiles"] == compiles

    def test_submit_validates_dists(self, tmp_cache):
        eng = self._engine()
        p = _stochastic(8, 51)
        with pytest.raises(ValueError, match="only meaningful"):
            eng.submit("matpow", p, power=2, dists=torch.ones((2, 8)) / 8)
        with pytest.raises(ValueError):
            eng.submit("markov", p, power=2, dists=torch.ones((2, 5)) / 5)

    def test_daemon_end_to_end_with_spans(self, tmp_cache):
        # Markov requests flow submit -> bucket -> route -> stream ->
        # resolve under the daemon scheduler, steady state and evolve land
        # on their own routes, and the trace tags the request spans and
        # the per-route execute spans.
        clock = ManualClock()
        eng = self._engine(clock, trace=True)
        p0, p1 = _stochastic(8, 61), _stochastic(8, 62)
        d = torch.tensor(np.random.default_rng(63).random((4, 8)),
                         dtype=torch.float32)
        with eng:
            futs = [eng.submit("markov", p0),
                    eng.submit("markov", p1),
                    eng.submit("markov", p0, power=33, dists=d),
                    eng.submit("matpow", p0, power=3)]
            clock.advance(10.0)              # every bucket deadline fires
            steady0 = futs[0].result(timeout=TIMEOUT)
            steady1 = futs[1].result(timeout=TIMEOUT)
            evolved = futs[2].result(timeout=TIMEOUT)
            futs[3].result(timeout=TIMEOUT)
            snap = eng.stats()
            spans = eng.tracer.spans()
        want0 = steady_state(p0, validate=False)
        assert torch.equal(steady0.pi, want0.pi)
        assert int(steady1.squarings) > 0
        assert torch.equal(evolved,
                           evolve_distributions(d, p0, 33, validate=False))
        assert snap["routes"]["evolve"] == 1
        assert snap["routes"]["torch"] >= 2  # steady bucket + matpow
        markov_tagged = [s for s in spans
                         if s["args"].get("op") == "markov"]
        assert len(markov_tagged) >= 3       # request + execute coverage
        exec_routes = {s["args"]["route"] for s in markov_tagged
                       if "route" in s["args"]}
        assert {"torch", "evolve"} <= exec_routes


# -- the port's own ------------------------------------------------------------

def _pair_stochastic(n, seed):
    """(jax array, torch tensor) of one float32 stochastic matrix."""
    import jax.numpy as jnp
    m = _np_stochastic(n, seed).astype(np.float32)
    return jnp.asarray(m), torch.from_numpy(m.copy())


def _pair_dists(b, n, seed):
    import jax.numpy as jnp
    d = np.random.default_rng(seed).random((b, n)).astype(np.float32)
    d /= d.sum(axis=1, keepdims=True)
    return jnp.asarray(d), torch.from_numpy(d.copy())


def _evolve_mults(steps):
    return max(steps.bit_length() - 1, 0) + bin(steps).count("1")


class TestParityWithReference:
    """The same float32 numpy inputs through the reference (``"xla"`` and
    its chain in interpret mode) and the port (``"torch"`` and
    ``"cuda_chain"``)."""

    @pytest.mark.parametrize("n", [8, 45, 96])
    @pytest.mark.parametrize("backends", [("xla", "torch"),
                                          ("pallas_chain_interpret", CHAIN)],
                             ids=["torch", "chain"])
    def test_steady_state_vs_reference(self, n, backends):
        from repro.core import steady_state as jsteady
        jback, tback = backends
        jp, tp = _pair_stochastic(n, 100 + n)
        want = jsteady(jp, backend=jback)
        got = steady_state(tp, backend=tback)
        assert int(got.squarings) == int(want.squarings) < 20
        k = int(got.squarings)
        assert_close(got.pi, want.pi, "float32", n=n, mults=k)
        assert_close(got.matrix, want.matrix, "float32", n=n, mults=k)
        # the residuals are both the last squaring's rounding: below tol,
        # and of one size
        assert float(got.residual) <= 1e-6 and float(want.residual) <= 1e-6
        assert abs(float(got.residual) - float(want.residual)) <= 1e-6

    @pytest.mark.parametrize("n,b,steps,threshold", [
        (45, 4, 21, None),      # B <= n, the chain pads 45 -> 64
        (16, 40, 13, None),     # B > n: the dense fallback
        (45, 1, 100, None),     # one distribution, as a (1, n) stack
        (96, 8, 1000, None),
        (24, 6, 37, 1e-9),      # the fallback forced
    ])
    def test_evolve_vs_reference(self, n, b, steps, threshold):
        from repro.core import evolve_distributions as jevolve
        jp, tp = _pair_stochastic(n, 200 + n)
        jd, td = _pair_dists(b, n, 300 + b)
        for jback, tback in (("xla", "torch"),
                             ("pallas_chain_interpret", CHAIN)):
            want = jevolve(jd, jp, steps, backend=jback,
                           dense_threshold=threshold)
            got = evolve_distributions(td, tp, steps, backend=tback,
                                       dense_threshold=threshold)
            assert got.shape == (b, n)
            assert_close(got, want, "float32", n=n,
                         mults=_evolve_mults(steps))
            exact = as_f64(td) @ np.linalg.matrix_power(as_f64(tp), steps)
            assert_close(got, exact, "float32", n=n,
                         mults=_evolve_mults(steps))

    def test_single_distribution_vs_reference(self):
        from repro.core import evolve_distributions as jevolve
        jp, tp = _pair_stochastic(45, 7)
        jd, td = _pair_dists(1, 45, 8)
        want = jevolve(jd[0], jp, 50, backend="pallas_chain_interpret")
        got = evolve_distributions(td[0], tp, 50, backend=CHAIN)
        assert got.shape == (45,)
        assert_close(got, want, "float32", n=45, mults=_evolve_mults(50))


class TestPaddingNeverLeaks:
    def test_steady_state_on_a_padded_chain(self):
        """n = 45 pads to 64 on the chain: pi has 45 entries summing to 1,
        the matrix is (45, 45) with rows summing to 1, and the residual is
        that of the unpadded matrices."""
        p = _stochastic(45, 9)
        res = steady_state(p, backend=CHAIN)
        assert res.pi.shape == (45,) and res.matrix.shape == (45, 45)
        assert abs(float(res.pi.sum()) - 1.0) < 1e-6
        np.testing.assert_allclose(res.matrix.sum(dim=1).numpy(), 1.0,
                                   atol=1e-5)
        plain = steady_state(p, backend="torch")
        assert int(plain.squarings) == int(res.squarings)
        assert_close(res.pi, plain.pi, "float32", n=45,
                     mults=int(res.squarings))

    def test_evolve_rows_are_unpadded(self, monkeypatch):
        """The vector–matrix products run on 64 columns, the answer has 45,
        each a distribution."""
        widths = []
        real = ops.dense_matmul

        def spy(x, w):
            widths.append(x.shape[-1])
            return real(x, w)

        monkeypatch.setattr(ops, "dense_matmul", spy)
        p = _stochastic(45, 10)
        d = torch.full((3, 45), 1.0 / 45)
        out = evolve_distributions(d, p, 11, backend=CHAIN)
        assert set(widths) == {64} and len(widths) == bin(11).count("1")
        assert out.shape == (3, 45)
        np.testing.assert_allclose(out.sum(dim=1).numpy(), 1.0, atol=1e-5)


class TestDenseMatmul:
    @pytest.mark.parametrize("shape", [(5, 24), (2, 3, 24), (24,)])
    def test_vs_reference(self, shape):
        import jax.numpy as jnp
        from repro.kernels import ops as jops
        rng = np.random.default_rng(len(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        w = rng.standard_normal((24, 40)).astype(np.float32)
        want = jops.dense_matmul(jnp.asarray(x), jnp.asarray(w))
        K.reset_launches()
        got = ops.dense_matmul(torch.from_numpy(x), torch.from_numpy(w))
        assert got.shape == want.shape
        assert K.launch_counts()["plain_matmul"] == 1
        assert_close(got, want, "float32", n=24)

    def test_empty_leading_dims(self):
        out = ops.dense_matmul(torch.zeros((0, 24)), torch.zeros((24, 8)))
        assert out.shape == (0, 8)

    def test_refuses_grad_until_the_backward_is_ported(self):
        """The backward is ported: under grad ``dense_matmul`` gives the
        gradient of x @ w with respect to whichever operand requires it,
        each through one more launch of K1's plain version here, and
        without grad it is the one forward launch."""
        rng = np.random.default_rng(11)
        xv = rng.standard_normal((2, 8)).astype(np.float32)
        wv = rng.standard_normal((8, 4)).astype(np.float32)
        g = rng.standard_normal((2, 4)).astype(np.float32)
        x = torch.tensor(xv, requires_grad=True)
        K.reset_launches()
        ops.dense_matmul(x, torch.from_numpy(wv)).backward(
            torch.from_numpy(g))
        assert K.launch_counts()["plain_matmul"] == 2
        assert_close(x.grad, g @ wv.T, "float32", n=4)
        w = torch.tensor(wv, requires_grad=True)
        K.reset_launches()
        ops.dense_matmul(torch.from_numpy(xv), w).backward(
            torch.from_numpy(g))
        assert K.launch_counts()["plain_matmul"] == 2
        assert_close(w.grad, xv.T @ g, "float32", n=2)
        with torch.no_grad():
            K.reset_launches()
            assert ops.dense_matmul(x, w).shape == (2, 4)
            assert K.launch_counts()["plain_matmul"] == 1

    def test_routing_follows_the_device(self):
        assert ops.dense_routing_active("cpu") is False
        if torch.cuda.is_available():
            assert ops.dense_routing_active() is True
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ops.dense_routing_active()
