"""The port's training path against the reference's, on the CPU.

``train/train_step.py`` (with ``train/loss.py``, ``train/optimizer.py`` and
``models``' remat under it) against the reference's
``jax.jit(make_train_step(...))``: the same smoke config, the reference's
initial state carried by ``convert.train_state_from_reference`` and the
same numpy batch. One step of the dense (qwen3-1.7b), ssm (mamba2-130m)
and moe (mixtral-8x7b) smoke configs, one with ``accum=2`` and one with
int8 moments.

Tolerances. ``DENSE_BUDGET["float32"]`` (rtol 2e-3, atol 1e-5) on the
metrics and on the gradients themselves, which the first step's moments
hold exactly scaled: m = (1 - b1) g and v = (1 - b2) g^2 of the clipped
gradient (int8 moments: within one quantization step of the block as
well). The new params are held to an absolute 2 * lr more: AdamW's first
update is lr * sign(g) wherever |g| is tiny, so a gradient whose sign the
two frameworks' rounding flips moves its parameter by 2 * lr (lr = 5e-3 at
``warmup=2``, ``peak_lr=1e-2``). MoE routing is a discrete choice: the
step's batch is checked to have no token whose k-th and (k+1)-th router
probabilities nearly tie (``TIE_GAP`` of tests/test_torch_model.py).

Then the reference's own tests/test_system.py on the port (loss falls over
40 steps, resume after a checkpoint is bit-exact, the int8 optimizer
trains, the LR schedule, AdamW, the quantize round trip), the chunked CE
against the reference, and ``launch/train.py``.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parity  # noqa: F401  (the port's tuning cache off ~/.cache)
from repro.configs import get_config as jget
from repro.models import init_params as jinit_params
from repro.parallel.collectives import quantize_int8 as jquantize
from repro.train.loss import chunked_cross_entropy as jcce
from repro.train.optimizer import cosine_lr as jcosine
from repro.train.train_step import (init_train_state as jinit_state,
                                    make_train_step as jmake_step)
from repro_torch import convert, models
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import SyntheticStream
from repro_torch.kernels import DENSE_BUDGET
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.parallel.collectives import dequantize_int8, quantize_int8
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (QTensor, adamw_init, adamw_update,
                                         cosine_lr)
from repro_torch.train.train_step import init_train_state, make_train_step

RTOL, ATOL = DENSE_BUDGET["float32"]
PEAK, WARMUP = 1e-2, 2
LR0 = PEAK / WARMUP          # lr of the first step
TIE_GAP = 1e-5               # tests/test_torch_model.py's float32 gap
B1, B2 = 0.9, 0.95


def _cfgs(arch, **kw):
    return (get_config(arch, smoke=True).replace(**kw),
            jget(arch, smoke=True).replace(**kw))


def _batch(cfg, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "targets": torch.from_numpy(toks[:, 1:].copy())}
    return jb, tb


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).astype(np.float64)
    return np.asarray(x).astype(np.float64)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _dequant(x):
    if isinstance(x, QTensor):
        return _np(x.dequantize()), _np(x.scale)
    if hasattr(x, "q"):                       # the reference's QTensor
        return _np(x.dequantize()), _np(x.scale)
    return _np(x), None


def _no_routing_ties(cfg, state, batch):
    """Every token's k-th and (k+1)-th router probabilities, in every MoE
    layer of a forward of ``batch``, are more than ``TIE_GAP`` apart."""
    probs = []
    dispatch = L._moe_dispatch

    def recording(*a):
        res = dispatch(*a)
        probs.append(res[2])
        return res

    L._moe_dispatch = recording
    try:
        with torch.no_grad():
            models.forward(cfg, state["params"], batch["tokens"])
    finally:
        L._moe_dispatch = dispatch
    assert probs
    for p in probs:
        top = torch.sort(p, dim=-1, descending=True).values
        gap = torch.log(top[..., cfg.top_k - 1]) - torch.log(top[...,
                                                                cfg.top_k])
        assert gap.min() > TIE_GAP


STEP_CASES = [("qwen3-1.7b", 1, "float32"), ("mamba2-130m", 1, "float32"),
              ("mixtral-8x7b", 1, "float32"), ("qwen3-1.7b", 2, "float32"),
              ("qwen3-1.7b", 1, "int8")]


@pytest.mark.parametrize("arch,accum,moments", STEP_CASES)
def test_one_step_matches_the_reference(arch, accum, moments):
    cfg, jcfg = _cfgs(arch, optimizer_state_dtype=moments)
    jstate = jinit_state(jcfg, jinit_params(jcfg, jax.random.PRNGKey(0)))
    state = convert.train_state_from_reference(jstate, device="cpu")
    jb, tb = _batch(cfg)
    if cfg.n_experts:
        _no_routing_ties(cfg, state, tb)
    jstep = jax.jit(jmake_step(jcfg, warmup=WARMUP, peak_lr=PEAK,
                               accum=accum))
    jnew, jmet = jstep(jstate, jb)
    step = make_train_step(cfg, warmup=WARMUP, peak_lr=PEAK, accum=accum)
    new, met = step(state, tb)
    assert new is state                      # updated in place

    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert met[k].shape == () and met[k].dtype == torch.float32, k
        np.testing.assert_allclose(_np(met[k]), _np(jmet[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1

    jm, jv = dict(_paths(jnew["opt"]["m"])), dict(_paths(jnew["opt"]["v"]))
    for name, p in _paths(new["params"]):
        # the clipped gradient, through the first step's moments
        for mom, jmom, coef in ((new["opt"]["m"], jm, 1 - B1),
                                (new["opt"]["v"], jv, 1 - B2)):
            got, scale = _dequant(dict(_paths(mom))[name])
            want, jscale = _dequant(jmom[name])
            atol = ATOL * coef
            if scale is not None:             # one int8 step of the block
                atol += np.repeat(np.maximum(scale, jscale), 256)[
                    :got.size].reshape(got.shape)
            excess = np.abs(got - want) - (atol + RTOL * np.abs(want))
            assert excess.max() <= 0, (name, coef, excess.max())
        np.testing.assert_allclose(
            _np(p), _np(dict(_paths(jnew["params"]))[name]), rtol=RTOL,
            atol=ATOL + 2 * LR0, err_msg=f"{name} param")


def test_cast_params_microbatch_matches_step_in_f32():
    """With f32 compute the two cast placements are the same arithmetic."""
    cfg, _ = _cfgs("qwen3-1.7b")
    jb, tb = _batch(cfg)
    out = []
    for where in ("step", "microbatch"):
        params = models.init_params(cfg, torch.Generator().manual_seed(0))
        state = init_train_state(cfg, params)
        _, met = make_train_step(cfg, cast_params=where, accum=2)(state, tb)
        out.append((met, state))
    for k in ("loss", "grad_norm"):
        assert torch.equal(out[0][0][k], out[1][0][k])
    with pytest.raises(ValueError, match="cast_params"):
        make_train_step(cfg, cast_params="never")


def test_bf16_compute_takes_gradients_of_the_cast_copy():
    """With bf16 compute and ``cast_params="step"`` the step runs the
    model on the bf16 copy and updates the fp32 masters; the metrics come
    back finite and the masters stay fp32."""
    cfg, _ = _cfgs("qwen3-1.7b", compute_dtype="bfloat16")
    state = init_train_state(cfg, models.init_params(
        cfg, torch.Generator().manual_seed(0)))
    before = state["params"]["blocks"]["mlp"]["w_up"].clone()
    _, tb = _batch(cfg)
    _, met = make_train_step(cfg, accum=2)(state, tb)
    assert all(torch.isfinite(v) for v in met.values())
    w = state["params"]["blocks"]["mlp"]["w_up"]
    assert w.dtype == torch.float32 and not torch.equal(w, before)


# ---------------------------------------------------------------------------
# The reference's tests/test_system.py, on the port
# ---------------------------------------------------------------------------

def _train(cfg, steps, state=None, stream=None, accum=1):
    if state is None:
        params = models.init_params(cfg, torch.Generator().manual_seed(0))
        state = init_train_state(cfg, params)
    if stream is None:
        stream = SyntheticStream(cfg, seed=0, batch=8, seq=64, device="cpu")
    step = make_train_step(cfg, warmup=5, peak_lr=3e-3, total_steps=steps,
                           accum=accum)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, next(stream))
        losses.append(float(metrics["loss"]))
    return state, stream, losses


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m"])
def test_loss_decreases(arch):
    cfg = get_config(arch, smoke=True)
    _, _, losses = _train(cfg, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses[::8]


def test_checkpoint_resume_bitexact(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore into a fresh
    state, train 3."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    state_a, _, _ = _train(cfg, 6)

    state_b, _, _ = _train(cfg, 3)
    ck = Checkpointer(tmp_path)
    ck.save(3, state_b)
    fresh = init_train_state(cfg, models.init_params(
        cfg, torch.Generator().manual_seed(9)))
    _, restored = ck.restore(3, fresh)
    stream_c = SyntheticStream(cfg, seed=0, batch=8, seq=64, start_step=3,
                               device="cpu")
    state_c, _, _ = _train(cfg, 3, state=restored, stream=stream_c)
    for (k, a), (_, c) in zip(_paths(state_a), _paths(state_c)):
        assert torch.equal(a, c), k


def test_int8_optimizer_states_train():
    cfg = get_config("qwen3-1.7b", smoke=True).replace(
        optimizer_state_dtype="int8")
    _, _, losses = _train(cfg, 40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


@pytest.mark.parametrize("step", [0, 3, 10, 40, 100, 150])
def test_cosine_lr_schedule(step):
    got = float(cosine_lr(torch.tensor(step, dtype=torch.int32), peak=1.0,
                          warmup=10, total=100))
    want = float(jcosine(jnp.int32(step), peak=1.0, warmup=10, total=100))
    assert abs(got - want) < 1e-6
    if step == 0:
        assert abs(got - 0.1) < 1e-6
    if step == 10:
        assert abs(got - 1.0) < 1e-6
    if step >= 100:
        assert abs(got - 0.1) < 1e-6     # floor_frac


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_step_moves_toward_minimum(moments):
    params = {"w": torch.tensor([4.0, -2.0])}
    opt = adamw_init(params, moments)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw (w^2)
        params, opt = adamw_update(params, grads, opt, lr=0.05,
                                   weight_decay=0.0, state_dtype=moments)
    assert float(params["w"].abs().max()) < 0.15
    assert int(opt["step"]) == 200


@pytest.mark.parametrize("moments", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_the_reference_in_place(moments):
    """Three steps of ``adamw_update`` on the reference's and the port's
    copies of the same tree: the port writes into the tensors it is given
    and returns them; the values match under the f32 budget (int8 moments:
    within one quantization step of the block too)."""
    from repro.train.optimizer import (adamw_init as jinit,
                                       adamw_update as jupdate)
    rng = np.random.default_rng(1)
    pv = {"a": rng.standard_normal(300).astype(np.float32),
          "b": {"c": rng.standard_normal((7, 5)).astype(np.float32)}}
    gvs = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), pv) for _ in range(3)]
    jp, jo = jax.tree.map(jnp.asarray, pv), jinit(
        jax.tree.map(jnp.asarray, pv), moments)
    tp = jax.tree.map(torch.from_numpy, pv)
    to = adamw_init(tp, moments)
    for gv in gvs:
        jp, jo = jupdate(jp, jax.tree.map(jnp.asarray, gv), jo, lr=0.1,
                         state_dtype=moments)
        same_p, same_o = adamw_update(tp, jax.tree.map(torch.from_numpy, gv),
                                      to, lr=0.1, state_dtype=moments)
        assert same_p is tp and same_o is to
    assert int(to["step"]) == int(jo["step"]) == 3
    for (k, got), (_, want) in zip(_paths(tp), _paths(jp)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for which in ("m", "v"):
        jm = dict(_paths(jo[which]))
        for name, leaf in _paths(to[which]):
            got, scale = _dequant(leaf)
            want, jscale = _dequant(jm[name])
            atol = ATOL if scale is None else ATOL + np.repeat(
                np.maximum(scale, jscale), 256)[:got.size].reshape(got.shape)
            excess = np.abs(got - want) - (atol + RTOL * np.abs(want))
            assert excess.max() <= 0, (which, name, excess.max())


def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    xv = rng.standard_normal(10_000).astype(np.float32)
    x = torch.from_numpy(xv)
    q, s, meta = quantize_int8(x)
    back = dequantize_int8(q, s, meta)
    assert float((back - x).abs().max()) < float(x.abs().max()) / 127 + 1e-6
    jq, js, jmeta = jquantize(jnp.asarray(xv))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert meta == (tuple(jmeta[0]), jmeta[1])


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 512), (24, 16), (32, 8)])
def test_chunked_cross_entropy_value_and_grad(s, chunk):
    """Value and gradients (of x and of the tied embedding) against the
    reference's at the same chunk rule (16 halves to 8 for S = 24)."""
    cfg, jcfg = _cfgs("qwen3-1.7b")
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(s)
    xv = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tv = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    mv = (rng.random((2, s)) < 0.8).astype(np.float32)

    def jf(x, emb):
        return jcce(jcfg, {**jp, "embed": emb}, x, jnp.asarray(tv),
                    chunk=chunk, mask=jnp.asarray(mv))

    jval, (jdx, jde) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(xv), jp["embed"])
    x = torch.tensor(xv, requires_grad=True)
    emb = tp["embed"].clone().requires_grad_()
    val = chunked_cross_entropy(cfg, {**tp, "embed": emb}, x,
                                torch.from_numpy(tv), chunk=chunk,
                                mask=torch.from_numpy(mv))
    dx, de = torch.autograd.grad(val, (x, emb))
    for got, want in ((val, jval), (dx, jdx), (de, jde)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------

def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_cli.main(argv) == 0
    return buf.getvalue().splitlines()


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "4", "--seq",
            "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--log-every", "1"]
    lines = _run(argv + ["--steps", "3"])
    assert lines[0].startswith("[train] qwen3-1.7b-smoke on cpu")
    logs = [ln for ln in lines if ln.startswith("[train] step ")]
    assert len(logs) == 3
    for ln in logs:
        for key in ("loss", "ce", "gnorm", "lr", "ms)"):
            assert key in ln, ln
    assert Checkpointer(tmp_path).steps() == [2, 3]
    lines = _run(argv + ["--steps", "5"])
    assert "[train] resumed from step 3" in lines
    assert [ln.split()[2] for ln in lines
            if ln.startswith("[train] step ")] == ["3", "4"]
    assert Checkpointer(tmp_path).latest_step() == 5


def test_cli_runs_on_the_card_unless_told_otherwise():
    argv = ["--arch", "mamba2-130m", "--smoke", "--steps", "1"]
    if torch.cuda.is_available():
        _run(argv)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(argv)


def test_build_refuses_a_mesh():
    """Without a mesh ``build`` gives no shardings; a mesh must be a
    ``DeviceMesh`` (``build(mesh=...)``: tests/test_torch_sharding.py)."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    step, shardings = train_cli.build(cfg, steps_total=3, peak_lr=1e-3,
                                      accum=1)
    assert callable(step) and shardings is None
    with pytest.raises(ValueError, match="DeviceMesh"):
        train_cli.build(cfg, mesh=object(), steps_total=3, peak_lr=1e-3,
                        accum=1)


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """The SSD's intra-chunk decay L[i, j] = exp(cum_i - cum_j) is masked
    above the diagonal. The reference masks after the exp, so where the
    masked exponent overflows (a chunk long enough, a decay fast enough:
    Mamba2-130m at full depth in bf16) its gradient is 0 * inf = NaN. The
    port masks the exponent: the same output, a finite gradient."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    cfg, jcfg = _cfgs("mamba2-130m", ssm_chunk=64)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    blk = jax.tree.map(lambda x: x[0], jp["blocks"]["ssm"])
    blk["A_log"] = jnp.full_like(blk["A_log"], np.log(1e4))
    x = np.random.default_rng(0).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)

    def jf(p, xv):
        return jnp.sum(jssm.ssm_block(jcfg, p, xv))

    jout = jax.jit(lambda p, xv: jssm.ssm_block(jcfg, p, xv))(
        blk, jnp.asarray(x))
    jg = jax.jit(jax.grad(jf))(blk, jnp.asarray(x))
    assert not all(bool(jnp.isfinite(v).all())
                   for v in jax.tree.leaves(jg))       # the reference's NaN
    tp = {k: convert.from_reference(np.asarray(v), device="cpu")
          .requires_grad_() for k, v in blk.items()}
    out = tssm.ssm_block(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(out.sum(), list(tp.values()))
    assert all(torch.isfinite(g).all() for g in grads)
