"""``serve/engine.py`` and ``launch/serve.py`` against the reference's.

Greedy generation with the reference's weights (carried by
``convert.params_from_reference``) picks the reference's tokens at every
step whose top-2 logit gap exceeds the tolerance ``DENSE_BUDGET``
(float32) allows two logits (2 x (atol + rtol x |logit|)); from the first
step whose gap does not, the two may part and nothing after it is
compared. (At smoke widths the logits are under 1, so the bfloat16
budget's gap, about 0.3, leaves no step to compare: bf16 logits are held
elementwise in ``test_torch_model.py``.) Sampling at a
temperature draws from ``torch.Generator`` streams, which are not JAX's:
it is checked for reproducibility, never against the reference's tokens.
"""

import io
import contextlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget
from repro.models import decode_step as jdecode
from repro.serve.engine import generate as jgenerate, \
    prefill as jprefill, serve_config as jserve_config
from repro_torch import models
from repro_torch.configs import cache_specs, get_config
from repro_torch.kernels import DENSE_BUDGET
from repro_torch.kernels import matmul_kernels as K
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.serve import engine as E

from _torch_lm import lm_inputs, ref_params, to_jax, to_torch

NEW = 6


def _cfgs(arch, dtype="float32"):
    return (get_config(arch, smoke=True).replace(compute_dtype=dtype),
            jget(arch, smoke=True).replace(compute_dtype=dtype))


def _reference_run(jcfg, jp, jt, jkw, new):
    """The reference's greedy tokens and, for each, the top-2 logit gap and
    the largest |logit| of the step that chose it."""
    jcfg = jserve_config(jcfg)
    s_total = jt.shape[1] + (jcfg.n_vision_tokens
                             if jcfg.family == "vlm" else 0)
    logits, cache = jprefill(jcfg, jp, jt, cache_len=s_total + new, **jkw)
    toks, gaps, peaks = [], [], []
    for i in range(new):
        lg = np.asarray(logits[:, -1], np.float64)
        top = np.sort(lg, -1)
        gaps.append(top[:, -1] - top[:, -2])
        peaks.append(np.abs(lg).max(-1))
        tok = lg.argmax(-1)
        toks.append(tok)
        if i + 1 < new:
            logits, cache = jdecode(jcfg, jp, jnp.asarray(tok[:, None],
                                                          jnp.int32), cache)
    return np.stack(toks, 1), np.stack(gaps, 1), np.stack(peaks, 1)


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-1.7b", "float32"), ("mamba2-130m", "float32"),
    ("mixtral-8x7b", "float32"), ("zamba2-1.2b", "float32"),
    ("whisper-base", "float32"), ("llava-next-mistral-7b", "float32"),
    ("granite-34b", "float32")])
def test_greedy_generate_matches_the_reference(arch, dtype):
    cfg, jcfg = _cfgs(arch, dtype)
    jp, tp = ref_params(jcfg)
    toks, kw = lm_inputs(cfg, 2, 8, seed=11)
    jt, jkw = to_jax(toks, kw)
    tt, tkw = to_torch(toks, kw)
    want, gaps, peaks = _reference_run(jcfg, jp, jt, jkw, NEW)
    got = E.generate(cfg, tp, tt, max_new_tokens=NEW, **tkw).numpy()
    assert got.shape == (2, NEW)
    rtol, atol = DENSE_BUDGET[dtype]
    compared = 0
    for b in range(2):
        for i in range(NEW):
            if gaps[b, i] <= 2 * (atol + rtol * peaks[b, i]):
                break                     # a near-tie: the runs may part
            assert got[b, i] == want[b, i], (b, i)
            compared += 1
    assert compared >= 1


def test_reference_generate_is_the_greedy_run_it_stands_for():
    """``_reference_run`` is the reference's own ``generate``."""
    _, jcfg = _cfgs("qwen3-1.7b")
    jp, _ = ref_params(jcfg)
    jt = jnp.asarray(lm_inputs(jcfg, 2, 8, seed=11)[0])
    np.testing.assert_array_equal(
        np.asarray(jgenerate(jcfg, jp, jt, max_new_tokens=NEW)),
        _reference_run(jcfg, jp, jt, {}, NEW)[0])


def _greedy_by_forward(cfg, tp, tt, tkw, new):
    """Greedy tokens by re-running the whole forward each step."""
    seq, out = tt, []
    with torch.inference_mode():
        for _ in range(new):
            x = models.forward(cfg, tp, seq, **tkw)["x"][:, -1]
            tok = models.unembed(cfg, tp, x).argmax(-1)
            out.append(tok)
            seq = torch.cat([seq, tok[:, None].to(seq.dtype)], 1)
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "qwen3-1.7b"])
def test_generate_equals_greedy_by_forward(arch):
    """The port's default ``cache_len`` holds a vlm's vision embeddings
    too. The reference's counts the text prompt only, so for llava its
    decode attends to a cache that lost the vision positions and parts
    from its own forward (ROADMAP.md queue 3)."""
    cfg, jcfg = _cfgs(arch)
    cfg = E.serve_config(cfg)
    jp, tp = ref_params(jcfg)
    toks, kw = lm_inputs(cfg, 2, 8, seed=1)
    tt, tkw = to_torch(toks, kw)
    want = _greedy_by_forward(cfg, tp, tt, tkw, NEW)
    got = E.generate(cfg, tp, tt, max_new_tokens=NEW, **tkw)
    assert torch.equal(got, want)
    if cfg.family == "vlm":
        jt, jkw = to_jax(toks, kw)
        ref = np.asarray(jgenerate(jcfg, jp, jt, max_new_tokens=NEW, **jkw))
        assert not np.array_equal(ref, want.numpy())   # the reference's


def test_generate_is_deterministic_and_sampling_follows_its_generator():
    cfg, jcfg = _cfgs("qwen3-1.7b")
    _, tp = ref_params(jcfg)
    tt = torch.from_numpy(lm_inputs(cfg, 2, 8)[0])
    a = E.generate(cfg, tp, tt, max_new_tokens=NEW)
    assert torch.equal(a, E.generate(cfg, tp, tt, max_new_tokens=NEW))

    def sampled(seed):
        return E.generate(cfg, tp, tt, max_new_tokens=NEW, temperature=1.5,
                          generator=torch.Generator().manual_seed(seed))
    s1 = sampled(5)
    assert torch.equal(s1, sampled(5))
    assert not torch.equal(s1, sampled(6))
    assert s1.min() >= 0 and s1.max() < cfg.vocab_size


def test_generate_casts_once_and_launches_per_projection(monkeypatch):
    """One cast of the fp32 masters per ``generate`` call (bf16 compute),
    and one K1 (plain version here) per projection per call."""
    cfg, jcfg = _cfgs("qwen3-1.7b", "bfloat16")
    _, tp = ref_params(jcfg)
    tt = torch.from_numpy(lm_inputs(cfg, 2, 8)[0])
    casts = []
    real = E._cast_params

    def counting(c, p):
        casts.append(p["embed"].dtype)
        return real(c, p)

    monkeypatch.setattr(E, "_cast_params", counting)
    K.reset_launches()
    E.generate(cfg, tp, tt, max_new_tokens=NEW)
    assert casts == [torch.float32]
    assert K.launch_counts()["plain_matmul"] == NEW * cfg.n_layers * 7


def test_init_cache_follows_cache_specs():
    for arch in ("zamba2-1.2b", "whisper-base", "mixtral-8x7b"):
        cfg = get_config(arch, smoke=True)
        cache = E.init_cache(cfg, 3, 40, device="cpu")
        for key, spec in cache_specs(cfg, 3, 40).items():
            assert cache[key].shape == spec.shape
            assert cache[key].dtype == spec.dtype
            assert not cache[key].any()


def test_ssm_decode_cache_is_o1():
    cfg, jcfg = _cfgs("mamba2-130m")
    cfg = E.serve_config(cfg)
    _, tp = ref_params(jcfg)
    tt = torch.from_numpy(lm_inputs(cfg, 2, 4)[0])
    _, cache = E.prefill(cfg, tp, tt, cache_len=8)
    size0 = sum(x.numel() for x in cache.values())
    dec = E.make_decode_fn(cfg)
    for _ in range(10):
        _, cache = dec(tp, tt[:, :1], cache)
    assert sum(x.numel() for x in cache.values()) == size0
    assert int(cache["pos"][0]) == 14


def test_serving_runs_without_grad_and_dense_refuses_grad():
    """Serving runs without grad (one K1 launch a projection, as before);
    ``dense`` now has a backward: its weight gradient is x.T @ g, two more
    launches of K1's plain version."""
    cfg, jcfg = _cfgs("qwen3-1.7b")
    _, tp = ref_params(jcfg)
    lm = models.LM(cfg, params=tp)
    tt = torch.from_numpy(lm_inputs(cfg, 1, 4)[0])
    out = E.generate(cfg, lm.params(), tt, max_new_tokens=2)
    assert out.shape == (1, 2)
    rng = np.random.default_rng(5)
    xv = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    w = torch.randn(cfg.d_model, 8, generator=torch.Generator().manual_seed(
        5), requires_grad=True)
    x = torch.tensor(xv, requires_grad=True)
    K.reset_launches()
    L.dense(x, w).sum().backward()
    assert K.launch_counts()["plain_matmul"] == 3
    rtol, atol = DENSE_BUDGET["float32"]
    np.testing.assert_allclose(w.grad.numpy(),
                               np.repeat(xv.sum(0)[:, None], 8, axis=1),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3-1.7b", "--smoke"],
    ["--arch", "whisper-base", "--smoke", "--batch", "2", "--max-new", "3"],
    ["--arch", "llava-next-mistral-7b", "--smoke", "--batch", "1",
     "--prompt-len", "6", "--max-new", "3", "--temperature", "0.7"]])
def test_cli_on_the_cpu(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("[serve]") and "first call" in lines[0]
    assert "second call" in lines[1] and "tok/s" in lines[1]
    assert lines[2].startswith("[serve]   seq0:")


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--arch", "qwen3-1.7b", "--smoke"])
