"""``models/model.py`` and ``serve/engine.prefill`` against the reference,
for all ten smoke configs (f32) and bf16 variants of qwen3, mamba2 and
mixtral: ``forward`` logits, the prefill's last-token logits and cache, and
four teacher-forced ``decode_step``s (logits and cache), with the
reference's weights carried by ``convert.params_from_reference``.

Tolerance: ``DENSE_BUDGET`` of the compute dtype as ``(rtol, atol)``:
float32 (2e-3, 1e-5), bfloat16 (0.15, 0.05). The port's ``torch``
products (attention scores, SSD einsums, ``unembed``) run with
``exact_matmul_settings()`` in force (TF32 off), which the model's entry
points set.

MoE routing is a discrete choice: where the k-th and (k+1)-th router
probabilities of a token nearly tie (their log gap under ``TIE_GAP`` of
the dtype: a few units in the last place of a bf16 logit), the two
frameworks' rounding may pick different experts, and that row's outputs
then legitimately differ. Such rows are left out of the comparisons with
the reference (never out of the port's own decode-vs-forward check), and
every case keeps at least one row.

Also here: the ring-cache fault of the reference (a prompt longer than the
window with ``S % W != 0``), the cache layout against ``cache_specs``, and
the ``LM`` module.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget, ARCH_NAMES
from repro.models import forward as jforward, decode_step as jdecode, \
    unembed as junembed, init_params as jinit
from repro.serve.engine import serve_config as jserve_config, \
    prefill as jprefill
from repro_torch import convert, models
from repro_torch.configs import cache_specs, get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve import engine as E

from _torch_lm import assert_lm_close, f64, lm_inputs, ref_params, \
    to_jax, to_torch

B, S, S0, CACHE_LEN = 2, 12, 8, 32
TIE_GAP = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
CASES = [(a, "float32") for a in ARCH_NAMES] + \
    [(a, "bfloat16") for a in ("qwen3-1.7b", "mamba2-130m", "mixtral-8x7b")]


def _cfgs(arch, dtype):
    return (E.serve_config(get_config(arch, smoke=True)
                           .replace(compute_dtype=dtype)),
            jserve_config(jget(arch, smoke=True)
                          .replace(compute_dtype=dtype)))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{d}" for a, d in CASES])
def case(request):
    """One config's reference and port runs, computed once: forward over
    S tokens, prefill of the first S0, then S - S0 teacher-forced decode
    steps."""
    arch, dtype = request.param
    cfg, jcfg = _cfgs(arch, dtype)
    jp, tp = ref_params(jcfg)
    toks, kw = lm_inputs(cfg, B, S)
    jt, jkw = to_jax(toks, kw)
    tt, tkw = to_torch(toks, kw)
    out = {"cfg": cfg, "dtype": dtype}

    jo = jforward(jcfg, jp, jt, **jkw)
    out["want_logits"] = junembed(jcfg, jp, jo["x"])
    out["want_aux"] = jo["aux"]
    probs = []
    dispatch = L._moe_dispatch

    def recording(*a):
        res = dispatch(*a)
        probs.append(res[2])
        return res

    L._moe_dispatch = recording
    try:
        with torch.inference_mode():
            to = models.forward(cfg, tp, tt, **tkw)
    finally:
        L._moe_dispatch = dispatch
    out["got_logits"] = models.unembed(cfg, tp, to["x"])
    out["got_aux"] = to["aux"]
    out["rows"] = _untied_rows(probs, cfg.top_k, TIE_GAP[dtype])
    assert out["rows"], "every row has a routing near-tie"
    if dtype == "float32":
        assert out["rows"] == list(range(B))

    jlast, jc = jprefill(jcfg, jp, jt[:, :S0], cache_len=CACHE_LEN, **jkw)
    tlast, tc = E.prefill(cfg, tp, tt[:, :S0], cache_len=CACHE_LEN, **tkw)
    out["prefill"] = (tlast, jlast, tc, jc)
    steps = []
    for t in range(S0, S):
        jlg, jc = jdecode(jcfg, jp, jt[:, t:t + 1], jc)
        with torch.inference_mode():
            tlg, tc = models.decode_step(cfg, tp, tt[:, t:t + 1], tc)
        steps.append((tlg, jlg))
    out["steps"] = steps
    out["final_cache"] = (tc, jc)
    return out


def _untied_rows(probs, k, gap):
    """Batch rows none of whose tokens, in any MoE layer, has its k-th and
    (k+1)-th router probabilities within ``gap`` in log space."""
    rows = set(range(B))
    for p in probs:
        top = torch.sort(p, dim=-1, descending=True).values
        near = (torch.log(top[..., k - 1]) - torch.log(top[..., k])) < gap
        rows -= set(torch.nonzero(near.any(-1)).flatten().tolist())
    return sorted(rows)


def _rows(x, rows, lead=0):
    """``x`` restricted to the compared batch rows (batch axis ``lead``)."""
    x = x if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    idx = (slice(None),) * lead + (list(rows),)
    return x[idx]


def test_forward_logits(case):
    r = case["rows"]
    assert_lm_close(_rows(case["got_logits"], r),
                    _rows(case["want_logits"], r), case["dtype"],
                    "forward logits")
    if len(r) == B:
        assert_lm_close(case["got_aux"], case["want_aux"], "float32", "aux")


def test_prefill_last_logits(case):
    tlast, jlast, _, _ = case["prefill"]
    assert tlast.dtype == torch.float32 and tlast.shape == (B, 1,
                                                             case["cfg"]
                                                             .vocab_size)
    assert_lm_close(_rows(tlast, case["rows"]), _rows(jlast, case["rows"]),
                    case["dtype"], "prefill logits")


def _cache_close(tc, jc, case):
    for key in tc:
        lead = 0 if key == "pos" else 1           # (layers, batch, ...)
        assert_lm_close(_rows(tc[key], case["rows"], lead),
                        _rows(jc[key], case["rows"], lead), case["dtype"],
                        key)


def test_prefill_cache_matches_reference_and_specs(case):
    _, _, tc, jc = case["prefill"]
    specs = cache_specs(case["cfg"], B, CACHE_LEN)
    assert set(tc) == set(jc) == set(specs)
    for key, spec in specs.items():
        assert tuple(tc[key].shape) == spec.shape, key
        assert tc[key].dtype == spec.dtype, key
    _cache_close(tc, jc, case)


def test_teacher_forced_decode_steps(case):
    off = case["cfg"].n_vision_tokens if case["cfg"].family == "vlm" else 0
    r = case["rows"]
    for i, (got, want) in enumerate(case["steps"]):
        assert got.shape == (B, 1, case["cfg"].vocab_size)
        assert_lm_close(_rows(got, r), _rows(want, r), case["dtype"],
                        f"decode step {i}")
        # and the port's own teacher-forced forward at that position, for
        # every row
        assert_lm_close(got[:, 0], case["got_logits"][:, off + S0 + i],
                        case["dtype"], f"decode step {i} vs forward")


def test_decode_cache_after_steps(case):
    tc, jc = case["final_cache"]
    assert set(tc) == set(jc)
    _cache_close(tc, jc, case)
    np.testing.assert_array_equal(tc["pos"].numpy(),
                                  np.full(B, S + (case["cfg"].n_vision_tokens
                                                  if case["cfg"].family
                                                  == "vlm" else 0)))


# ---------------------------------------------------------------------------
# The ring-cache fault of the reference (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixtral():
    cfg, jcfg = _cfgs("mixtral-8x7b", "float32")
    jp, tp = ref_params(jcfg)
    return cfg, jcfg, jp, tp


def _ring_errors(mixtral, s0):
    """Max abs error of 4 decode steps after an ``s0``-token prefill
    against the same model's teacher-forced forward: (port, reference)."""
    cfg, jcfg, jp, tp = mixtral
    toks, _ = lm_inputs(cfg, 2, s0 + 4, seed=7)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    with torch.inference_mode():
        full = models.unembed(cfg, tp, models.forward(cfg, tp, tt)["x"])
    _, tc = E.prefill(cfg, tp, tt[:, :s0], cache_len=64)
    jfull = junembed(jcfg, jp, jforward(jcfg, jp, jt)["x"])
    _, jc = jprefill(jcfg, jp, jt[:, :s0], cache_len=64)
    got, want = [], []
    for t in range(s0, s0 + 4):
        with torch.inference_mode():
            lg, tc = models.decode_step(cfg, tp, tt[:, t:t + 1], tc)
        jlg, jc = jdecode(jcfg, jp, jt[:, t:t + 1], jc)
        got.append(np.abs(f64(lg[:, 0]) - f64(full[:, t])).max())
        want.append(np.abs(f64(jlg[:, 0]) - f64(jfull[:, t])).max())
    return max(got), max(want), f64(full)


@pytest.mark.parametrize("s0", [20, 36])
def test_ring_cache_after_a_prompt_longer_than_the_window(mixtral, s0):
    """Window 16, S % W != 0: the port's decode equals its own forward
    (DENSE_BUDGET float32); the reference's differs by tenths, because
    its prefill keeps the last W keys oldest-first and its first decode
    overwrites one still inside the window."""
    cfg = mixtral[0]
    assert cfg.sliding_window == 16 and s0 > 16 and s0 % 16
    got, ref_err, full = _ring_errors(mixtral, s0)
    rtol, atol = 2e-3, 1e-5                  # DENSE_BUDGET["float32"]
    assert got <= atol + rtol * np.abs(full).max()
    assert ref_err > 0.05                     # the reference's fault


@pytest.mark.parametrize("s0", [16, 32])
def test_ring_cache_at_a_window_multiple_equals_the_reference(mixtral, s0):
    got, ref_err, full = _ring_errors(mixtral, s0)
    assert got <= 1e-5 + 2e-3 * np.abs(full).max()
    assert ref_err <= 1e-5 + 2e-3 * np.abs(full).max()


@pytest.mark.parametrize("s_total,cache_len,window", [
    (20, 64, 16), (20, 8, None), (12, 64, None), (12, 5, 8), (16, 64, 16)])
def test_kept_positions_sit_at_their_ring_slots(s_total, cache_len, window):
    """``_ring`` / ``_pad_cache``: after a prefill, the slot ``p % C`` of a
    C-slot cache holds position p, for each of the last C positions."""
    cfg = get_config("qwen3-1.7b", smoke=True).replace(
        sliding_window=window)
    pos = torch.arange(s_total, dtype=torch.float32)
    kv = pos.reshape(1, 1, s_total, 1, 1).expand(2, 3, s_total, 1, 1)
    klen = s_total if window is None else min(window, s_total)
    cache = {"k": M._ring(kv, s_total, klen)}
    cache = M._pad_cache(cfg, cache, cache_len, s_total)
    c = cache["k"].shape[2]
    assert c == (cache_len if window is None else min(cache_len, window))
    for p in range(max(0, s_total - c), s_total):
        assert cache["k"][0, 0, p % c, 0, 0] == p
    if s_total < c:
        assert (cache["k"][:, :, s_total:] == 0).all()


# ---------------------------------------------------------------------------
# Weights: init_params, the LM module, params_from_reference
# ---------------------------------------------------------------------------

def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_params_tree_equals_the_reference(arch):
    cfg = get_config(arch, smoke=True)
    jshapes = jax.eval_shape(lambda k: jinit(jget(arch, smoke=True), k),
                             jax.random.PRNGKey(0))
    tree = models.init_params(cfg, torch.Generator().manual_seed(0))
    got = {k: (tuple(v.shape), v.dtype) for k, v in _paths(tree)}
    want = {k: (tuple(v.shape), torch.float32) for k, v in _paths(jshapes)}
    assert got == want
    assert sum(v.numel() for _, v in _paths(tree)) == cfg.n_params()
    # reproducible from the generator's seed
    again = models.init_params(cfg, torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(_paths(tree), _paths(again)):
        assert torch.equal(a, b), k


def test_lm_module_owns_the_tree(mixtral):
    cfg, _, jp, tp = mixtral
    lm = models.LM(cfg, params=tp)
    want = {k: tuple(np.shape(v)) for k, v in _paths(jp)}
    assert {k: tuple(v.shape) for k, v in lm.state_dict().items()} == want
    assert all(not p.requires_grad for p in lm.parameters())
    toks = torch.from_numpy(lm_inputs(cfg, 2, 6)[0])
    with torch.inference_mode():
        x = lm(toks)["x"]
        torch.testing.assert_close(lm.unembed(x), models.unembed(
            cfg, tp, models.forward(cfg, tp, toks)["x"]))
    fresh = models.LM(cfg, generator=torch.Generator().manual_seed(3))
    fresh.load_state_dict(lm.state_dict())
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, lm.state_dict()[k]), k
    with pytest.raises(ValueError, match="exactly one"):
        models.LM(cfg)


def test_params_from_reference_keys_and_dtype(mixtral):
    _, _, jp, _ = mixtral
    tree = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                         device="cpu",
                                         dtype=torch.bfloat16)
    assert {k for k, _ in _paths(tree)} == {k for k, _ in _paths(jp)}
    assert all(v.dtype == torch.bfloat16 for _, v in _paths(tree))
