"""Config-driven model builder: decoder-only, MoE, SSM, hybrid, enc-dec.

The port of the reference's ``models/model.py``: one ``init_params`` /
``forward`` / ``decode_step`` triple covers all ten architectures. Layers
are stacked on a leading axis as in the reference; its ``lax.scan`` over
that axis is a Python loop here.

``forward`` returns pre-logits activations; ``unembed`` turns them into
fp32 logits with one ``torch.matmul`` (the reference's einsum outside any
kernel).

One deliberate difference: a prompt longer than a sliding window keeps its
last ``window`` keys at slot ``position % window`` of the ring cache
(``_ring``), where ``decode_step`` expects them. The reference keeps them
oldest-first in slots 0..W-1, so when ``S % W != 0`` its first decode
writes over a key still inside the window (``ROADMAP.md`` queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import DTYPES, exact_matmul_settings
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import ShardCtx, NO_SHARD

__all__ = ["init_params", "forward", "decode_step", "unembed",
           "sinusoidal_positions"]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _stack(trees):
    """A list of same-structured trees -> one tree of stacked tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _init_attn_layer(generator, cfg: ArchConfig, cross: bool = False):
    p = {
        "ln1": L.init_norm(generator, cfg),
        "attn": L.init_attention(generator, cfg),
        "ln2": L.init_norm(generator, cfg),
    }
    if cfg.n_experts:
        p["moe"] = L.init_moe(generator, cfg)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(generator, cfg)
    if cross:
        p["ln_cross"] = L.init_norm(generator, cfg)
        p["cross"] = L.init_attention(generator, cfg)
    return p


def _init_ssm_layer(generator, cfg: ArchConfig):
    return {"ln1": L.init_norm(generator, cfg),
            "ssm": S.init_ssm(generator, cfg)}


def init_params(cfg: ArchConfig, generator: torch.Generator):
    """Random weights for ``cfg`` with the reference's tree, shapes and
    distributions, drawn from ``generator`` (a ``torch.Generator`` on the
    device the weights are made on). The values differ from the
    reference's (another random stream); ``convert.params_from_reference``
    carries the reference's own weights across."""
    pdt = DTYPES[cfg.param_dtype]
    params = {
        "embed": L._normal(generator, (cfg.vocab_size, cfg.d_model), pdt,
                           0.02),
        "final_norm": L.init_norm(generator, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._normal(generator,
                                      (cfg.vocab_size, cfg.d_model), pdt,
                                      0.02)

    if cfg.layer_pattern:                           # zamba2 hybrid
        n_m_per = sum(k == "m" for k in cfg.layer_pattern)
        reps = cfg.n_pattern_repeats
        stacked = _stack([_init_ssm_layer(generator, cfg)
                          for _ in range(reps * n_m_per)])
        params["m_blocks"] = _map(
            lambda x: x.reshape((reps, n_m_per) + x.shape[1:]), stacked)
        params["shared_attn"] = _init_attn_layer(generator, cfg)
        if cfg.n_tail_layers:
            params["tail_blocks"] = _stack(
                [_init_ssm_layer(generator, cfg)
                 for _ in range(cfg.n_tail_layers)])
    elif cfg.family == "ssm":
        params["blocks"] = _stack(
            [_init_ssm_layer(generator, cfg) for _ in range(cfg.n_layers)])
    else:
        params["blocks"] = _stack(
            [_init_attn_layer(generator, cfg, cross=cfg.cross_attention)
             for _ in range(cfg.n_layers)])

    if cfg.encoder_layers:
        params["enc_blocks"] = _stack(
            [_init_attn_layer(generator, cfg)
             for _ in range(cfg.encoder_layers)])
        params["enc_norm"] = L.init_norm(generator, cfg)
    return params


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _layer(tree, i):
    """Layer ``i`` of a tree stacked on its leading axis."""
    return _map(lambda x: x[i], tree)


def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32,
                         device=None):
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    return _sinusoid(pos, d, dtype)


def _sinusoid(pos, d, dtype):
    """pos: (..., 1) float positions -> (..., d) sin | cos features."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None]
    angle = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def _ffn(cfg, p, x):
    """MLP or MoE sublayer; returns (y, aux_loss_scalar)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts:
        y, probs = L.moe_block(cfg, p["moe"], x)
        # Switch-style load-balance aux: E * sum_e f_e * P_e
        e = cfg.n_experts
        top1 = torch.argmax(probs, dim=-1)
        f = torch.mean(F.one_hot(top1, e).float(), dim=(0, 1))
        pbar = torch.mean(probs, dim=(0, 1))
        return y, e * torch.sum(f * pbar)
    if cfg.d_ff:
        return L.mlp_block(cfg, p["mlp"], x), zero
    return torch.zeros_like(x), zero


def _attn_layer_apply(cfg, p, x, *, positions, causal=None,
                      kv_cache=None, cross_kv=None):
    """Pre-LN attention (+optional cross-attn) + FFN. Returns
    (x, fresh_kv, aux)."""
    h, fresh_kv = L.attention_block(
        cfg, p["attn"], L._apply_norm(x, p["ln1"], cfg), positions=positions, kv_cache=kv_cache, use_rope=cfg.use_rope,
        causal=causal)
    x = x + h
    if cross_kv is not None:
        hc, _ = L.attention_block(
            cfg, p["cross"], L._apply_norm(x, p["ln_cross"], cfg),
            positions=None, use_rope=False, causal=False,
            kv_override=cross_kv)
        x = x + hc
    y, aux = _ffn(cfg, p, L._apply_norm(x, p["ln2"], cfg))
    return x + y, fresh_kv, aux


def _ssm_layers(cfg, blocks, x, want_state):
    """Run a stack of SSM layers; returns (x, [(state, conv)] per layer)."""
    states = []
    for i in range(_n_stacked(blocks)):
        blk = _layer(blocks, i)
        h = S.ssm_block(cfg, blk["ssm"], L._apply_norm(x, blk["ln1"], cfg),
                        return_state=want_state)
        if want_state:
            h, st = h
            states.append(st)
        x = x + h
    return x, states


def _ssm_decode_layers(cfg, blocks, x, st, cv):
    """One decode step through a stack of SSM layers with their states."""
    new_st, new_cv = [], []
    for i in range(_n_stacked(blocks)):
        blk = _layer(blocks, i)
        y, s2, c2 = S.ssm_decode_step(cfg, blk["ssm"],
                                      L._apply_norm(x, blk["ln1"], cfg),
                                      st[i], cv[i])
        x = x + y
        new_st.append(s2)
        new_cv.append(c2)
    return x, new_st, new_cv


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, tokens, *, vision_embeds=None):
    cdt = DTYPES[cfg.compute_dtype]
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.family == "vlm" and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(cdt), x], dim=1)
    if cfg.family == "audio":
        # decoder positions are sinusoidal (whisper-style)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, cdt,
                                     x.device)[None]
    return x


def _encode(cfg, params, frames):
    cdt = DTYPES[cfg.compute_dtype]
    x = frames.to(cdt) + sinusoidal_positions(
        frames.shape[1], cfg.d_model, cdt, frames.device)[None]
    blocks = params["enc_blocks"]
    for i in range(_n_stacked(blocks)):
        x, _, _ = _attn_layer_apply(cfg, _layer(blocks, i), x,
                                    positions=None, causal=False)
    return L._apply_norm(x, params["enc_norm"], cfg)


def _cast_params(cfg: ArchConfig, params):
    """Cast fp32 master weights to the compute dtype (mixed precision).
    A tree already in the compute dtype comes back as it is, so a caller
    that casts once (``serve.engine``) pays for it once."""
    cdt = DTYPES[cfg.compute_dtype]
    pdt = DTYPES[cfg.param_dtype]
    if cdt == pdt:
        return params
    return _map(lambda p: p.to(cdt) if p.dtype == pdt else p, params)


def _ring(kv, s_total: int, slots: int):
    """The last ``slots`` positions of ``kv`` (stacked (L, B, S, ...), the
    positions in order, ending at ``s_total - 1``) with position p at slot
    ``p % slots``, as ``decode_step``'s ring writes expect them."""
    return torch.roll(kv[:, :, -slots:], shifts=s_total % slots, dims=2)


def forward(cfg: ArchConfig, params, tokens, *, sctx: ShardCtx = NO_SHARD,
            frames=None, vision_embeds=None, return_cache: bool = False,
            cache_len: Optional[int] = None):
    """Full-sequence forward. Returns dict with:
       x        — final pre-logits activations (B, S_total, D)
       aux      — MoE load-balance loss (scalar)
       cache    — decode cache tree (when return_cache)
    """
    exact_matmul_settings()
    params = _cast_params(cfg, params)
    x = _embed_inputs(cfg, params, tokens, vision_embeds=vision_embeds)
    b, s_total, _ = x.shape
    positions = torch.arange(s_total, dtype=torch.int32,
                             device=x.device)[None, :]
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(cfg, params, frames)

    want_cache = return_cache
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}
    ks, vs = [], []

    if cfg.layer_pattern:                                   # ---- zamba2
        shared = params["shared_attn"]
        states = []
        for r in range(cfg.n_pattern_repeats):
            x, st = _ssm_layers(cfg, _layer(params["m_blocks"], r), x,
                                want_cache)
            states += st
            x, (k, v), _ = _attn_layer_apply(cfg, shared, x,
                                             positions=positions)
            if want_cache:
                ks.append(k)
                vs.append(v)
        if cfg.n_tail_layers:
            x, st = _ssm_layers(cfg, params["tail_blocks"], x, want_cache)
            states += st
        if want_cache:
            cache["ssm_state"] = torch.stack([s for s, _ in states])
            cache["conv_state"] = torch.stack([c for _, c in states])

    elif cfg.family == "ssm":                               # ---- mamba2
        x, states = _ssm_layers(cfg, params["blocks"], x, want_cache)
        if want_cache:
            cache["ssm_state"] = torch.stack([s for s, _ in states])
            cache["conv_state"] = torch.stack([c for _, c in states])

    else:                                                   # ---- attention
        blocks = params["blocks"]
        enc_ks, enc_vs = [], []
        for i in range(_n_stacked(blocks)):
            blk = _layer(blocks, i)
            ckv = None
            if enc_out is not None:
                # per-layer cross KV computed from encoder output
                shape = (b, enc_out.shape[1], cfg.n_kv_heads, cfg.d_head)
                ckv = (L.dense(enc_out, blk["cross"]["wk"]).reshape(shape),
                       L.dense(enc_out, blk["cross"]["wv"]).reshape(shape))
                enc_ks.append(ckv[0])
                enc_vs.append(ckv[1])
            x, (k, v), aux = _attn_layer_apply(
                cfg, blk, x, positions=positions, cross_kv=ckv)
            aux_total = aux_total + aux
            if want_cache:
                ks.append(k)
                vs.append(v)
        if want_cache and enc_ks:
            cache["enc_k"], cache["enc_v"] = (torch.stack(enc_ks),
                                              torch.stack(enc_vs))

    if want_cache and ks:
        # keep the last `klen` positions, each at slot `pos % klen`
        win = cfg.sliding_window
        klen = s_total if win is None else min(win, s_total)
        cache["k"] = _ring(torch.stack(ks), s_total, klen)
        cache["v"] = _ring(torch.stack(vs), s_total, klen)

    x = L._apply_norm(x, params["final_norm"], cfg)
    out = {"x": x, "aux": aux_total / max(cfg.n_layers, 1)}
    if want_cache:
        cache["pos"] = torch.full((b,), s_total, dtype=torch.int32,
                                  device=x.device)
        out["cache"] = _pad_cache(cfg, cache, cache_len, s_total)
    return out


def _pad_cache(cfg, cache, cache_len, s_total):
    """Grow KV buffers to cache_len slots for subsequent decoding, or keep
    the last ``cache_len`` positions in ring order when it is shorter."""
    if cache_len is None:
        return cache
    win = cfg.sliding_window
    eff = cache_len if win is None else min(cache_len, win)
    for key in ("k", "v"):
        if key in cache:
            cur = cache[key]
            s = cur.shape[2]
            if s < eff:
                # s < eff <= window: no position has wrapped yet
                pad = torch.zeros(cur.shape[:2] + (eff - s,) + cur.shape[3:],
                                  dtype=cur.dtype, device=cur.device)
                cache[key] = torch.cat([cur, pad], dim=2)
            elif s > eff:
                order = torch.roll(cur, shifts=-(s_total % s), dims=2)
                cache[key] = _ring(order, s_total, eff)
    return cache


def unembed(cfg: ArchConfig, params, x):
    """(..., D) -> (..., V) logits at fp32: one fp32 ``torch.matmul`` with
    ``exact_matmul_settings()`` in force."""
    exact_matmul_settings()
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), w.float().t())


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_step(cfg: ArchConfig, params, tokens, cache, *,
                sctx: ShardCtx = NO_SHARD):
    """One-token decode. tokens: (B,1). Returns (logits (B,1,V), new_cache).
    ``cache`` is left as it was."""
    exact_matmul_settings()
    params = _cast_params(cfg, params)
    b = tokens.shape[0]
    pos = cache["pos"]                                  # (B,) tokens so far
    cdt = DTYPES[cfg.compute_dtype]
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.family == "audio":
        x = x + _sinusoid(pos[:, None].float(), cfg.d_model, cdt)[:, None, :]
    positions = pos[:, None]
    new_cache = dict(cache)

    if cfg.layer_pattern:                               # ---- zamba2
        n_m_per = sum(k == "m" for k in cfg.layer_pattern)
        shared = params["shared_attn"]
        st, cv = cache["ssm_state"], cache["conv_state"]
        new_st, new_cv, ks, vs = [], [], [], []
        for r in range(cfg.n_pattern_repeats):
            lo = r * n_m_per
            x, s2, c2 = _ssm_decode_layers(
                cfg, _layer(params["m_blocks"], r), x, st[lo:lo + n_m_per],
                cv[lo:lo + n_m_per])
            new_st += s2
            new_cv += c2
            h, (k_r, v_r) = L.attention_block(
                cfg, shared["attn"], L._apply_norm(x, shared["ln1"], cfg),
                positions=positions, use_rope=cfg.use_rope,
                kv_cache=(cache["k"][r], cache["v"][r], pos))
            x = x + h
            y, _ = _ffn(cfg, shared, L._apply_norm(x, shared["ln2"], cfg))
            x = x + y
            ks.append(k_r)
            vs.append(v_r)
        if cfg.n_tail_layers:
            lo = cfg.n_pattern_repeats * n_m_per
            x, s2, c2 = _ssm_decode_layers(cfg, params["tail_blocks"], x,
                                           st[lo:], cv[lo:])
            new_st += s2
            new_cv += c2
        new_cache.update(ssm_state=torch.stack(new_st),
                         conv_state=torch.stack(new_cv),
                         k=torch.stack(ks), v=torch.stack(vs))

    elif cfg.family == "ssm":                           # ---- mamba2
        x, new_st, new_cv = _ssm_decode_layers(
            cfg, params["blocks"], x, cache["ssm_state"],
            cache["conv_state"])
        new_cache.update(ssm_state=torch.stack(new_st),
                         conv_state=torch.stack(new_cv))

    else:                                               # ---- attention
        has_cross = "enc_k" in cache
        blocks = params["blocks"]
        ks, vs = [], []
        for i in range(_n_stacked(blocks)):
            blk = _layer(blocks, i)
            h, (k_l, v_l) = L.attention_block(
                cfg, blk["attn"], L._apply_norm(x, blk["ln1"], cfg),
                positions=positions, use_rope=cfg.use_rope,
                kv_cache=(cache["k"][i], cache["v"][i], pos))
            x = x + h
            if has_cross:
                ek = cache["enc_k"][i]
                n_enc = torch.full((b,), ek.shape[1], dtype=torch.int32,
                                   device=x.device)
                hc, _ = L.attention_block(
                    cfg, blk["cross"], L._apply_norm(x, blk["ln_cross"], cfg),
                    positions=None, use_rope=False,
                    kv_cache=(ek, cache["enc_v"][i], n_enc),
                    cache_write=False)
                x = x + hc
            y, _ = _ffn(cfg, blk, L._apply_norm(x, blk["ln2"], cfg))
            x = x + y
            ks.append(k_l)
            vs.append(v_l)
        new_cache.update(k=torch.stack(ks), v=torch.stack(vs))

    new_cache["pos"] = pos + 1
    x = L._apply_norm(x, params["final_norm"], cfg)
    return unembed(cfg, params, x), new_cache
