"""Transformer building blocks — functions over explicit parameter trees.

The port of the reference's ``models/layers.py``. A parameter tree is a
nested ``dict`` of tensors with the reference's keys.

* Every projection (``dense``) and every MoE expert product goes through
  ``ops.dense_matmul``: K1 on a CUDA tensor, K1's plain version on a CPU
  tensor.
* Attention is the reference's portable online-softmax chunk scan, written
  as PyTorch tensor ops (the reference writes it in jnp, never through its
  flash kernel): KV chunks scanned per query chunk with a running (max,
  denom, acc), so a long prefill never materializes an S x S score matrix;
  sliding-window attention slices the KV *band* per query chunk. Scores and
  the P·V products are fp32 ``torch`` products of the compute-dtype
  operands, with ``exact_matmul_settings()`` in force (set by the model's
  entry points).
* ``ShardCtx`` exists with ``mesh=None`` only; sharding comes with the
  ``parallel`` slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import DTYPES
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as _kops

__all__ = [
    "ShardCtx", "NO_SHARD", "norm", "rope", "dense",
    "attention_block", "mlp_block", "moe_block", "init_attention",
    "init_mlp", "init_moe", "init_norm", "write_kv_cache",
]


# ---------------------------------------------------------------------------
# Sharding context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """The reference's activation-sharding context, single-device only.

    ``mesh=None`` is the one value ported: the functions take ``sctx`` as
    the reference's do and compute on one device. A mesh raises
    ``ValueError``; sharded serving and training come with the
    ``parallel`` slice.
    """
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise ValueError(
                "ShardCtx(mesh=...) is not ported yet: sharded LM serving "
                "and training come with the parallel/ slice; pass mesh=None")


NO_SHARD = ShardCtx()


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def norm(x, w, *, kind: str = "rmsnorm", eps: float = 1e-5, bias=None):
    dt = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind}")
    y = y * w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def rope(x, positions, *, theta: float = 10_000.0):
    """Rotary embedding. x: (..., S, H, D), positions: (..., S) int."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x, w, b=None):
    """x (..., D_in) @ w (D_in, D_out) through ``ops.dense_matmul`` (K1 on
    the card, with the tuning cache's tiles for the flattened problem).
    The output stays in the compute dtype."""
    y = _kops.dense_matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {kind}")


def _scaled(q, scale: float):
    """``q * scale`` with the scale rounded to q's dtype first, as the
    reference's ``q * q.dtype.type(scale)``."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

_NEG = -1e30

# Historical static chunk sizes — the fallback when the tuner cannot help.
_DEFAULT_Q_CHUNK, _DEFAULT_KV_CHUNK = 512, 1024


def _pick_chunks(sq: int, skv: int, d: int, dtype, device):
    """Tuned (q_chunk, kv_chunk) for the chunked-attention path.

    When the ``attention`` namespace of the tuning cache has an entry for
    this (sq, skv, d) problem on this device type, resolve it through
    ``ops.pick_attn_blocks``; the chunk scan pads ragged lengths itself, so
    a tuned tile that does not divide the sequence is still usable.
    Untuned problems keep the historical static chunks (512, 1024).
    """
    backend = torch.device(device).type
    try:
        if autotune.lookup(sq, skv, d, dtype=dtype, backend=backend,
                           kernel="attention") is not None:
            bq, bk = _kops.pick_attn_blocks(sq, skv, d, dtype=dtype,
                                            backend=backend)
            return int(bq), int(bk)
    except ValueError:
        pass
    return _DEFAULT_Q_CHUNK, _DEFAULT_KV_CHUNK


def _scores(q, k, eq: str):
    """fp32 scores of compute-dtype operands (``preferred_element_type``)."""
    return torch.einsum(eq, q.float(), k.float())


def _online_chunk_attention(q, k, v, *, causal: bool, q_offset: int,
                            q_chunk: int, kv_chunk: int):
    """Memory-efficient attention. q: (B,Sq,Hkv,G,D); k,v: (B,Skv,Hkv,D).

    Loops over query chunks (outer) and KV chunks (inner) keeping a running
    (max, denom, acc) — scores never exceed (B,Hkv,G,q_chunk,kv_chunk).
    Ragged lengths are padded up to the chunk size, not the chunk shrunk.
    """
    b, sq, hkv, g, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    sq_pad = -sq % q_chunk
    skv_pad = -skv % kv_chunk
    sq_t, skv_t = sq + sq_pad, skv + skv_pad
    if sq_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, sq_pad))
    if skv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_pad))
    n_q, n_kv = sq_t // q_chunk, skv_t // kv_chunk
    dev = q.device

    # (n_q, B, Hkv, G, q_chunk, D) and (n_kv, B, Hkv, kv_chunk, D)
    qc = _scaled(q, d ** -0.5).reshape(b, n_q, q_chunk, hkv, g, d) \
        .permute(1, 0, 3, 4, 2, 5)
    kc = k.reshape(b, n_kv, kv_chunk, hkv, d).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n_kv, kv_chunk, hkv, d).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(n_q):
        q_blk = qc[qi]                                  # (B,Hkv,G,qc,D)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_run = torch.full((b, hkv, g, q_chunk, 1), _NEG,
                           dtype=torch.float32, device=dev)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for ki in range(n_kv):
            k_blk, v_blk = kc[ki], vc[ki]               # (B,Hkv,kvc,D)
            s = _scores(q_blk, k_blk, "bhgqd,bhkd->bhgqk")
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (k_pos[None, :] < skv).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if causal or skv_pad:
                s = torch.where(mask, s, _NEG)
            m_cur = torch.amax(s, dim=-1, keepdim=True)
            m_new = torch.maximum(m_run, m_cur)
            p = torch.exp(s - m_new)
            corr = torch.exp(m_run - m_new)
            l_run = corr * l_run + torch.sum(p, dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v_blk.dtype).float(),
                v_blk.float())
            m_run = m_new
        l_safe = torch.where(l_run == 0.0, 1.0, l_run)
        outs.append((acc / l_safe).to(q.dtype))
    # (n_q, B, Hkv, G, q_chunk, D) -> (B, Sq, Hkv, G, D)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5) \
        .reshape(b, sq_t, hkv, g, d)
    return out[:, :sq] if sq_pad else out


def _banded_window_attention(q, k, v, *, window: int, q_offset: int,
                             q_chunk: int):
    """Sliding-window attention via per-chunk KV band slicing: O(S*window).

    For a query chunk starting at absolute position p, only keys in
    (p - window, p + q_chunk) can be visible; that band is sliced instead of
    visiting every KV chunk.
    """
    b, sq, hkv, g, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    while sq % q_chunk:
        q_chunk //= 2
    n_q = sq // q_chunk
    band = min(window + q_chunk, skv)
    dev = q.device

    qc = _scaled(q, d ** -0.5).reshape(b, n_q, q_chunk, hkv, g, d) \
        .permute(1, 0, 3, 4, 2, 5)
    outs = []
    for qi in range(n_q):
        q_start = q_offset + qi * q_chunk           # absolute pos in KV axis
        start = min(max(q_start - window + 1, 0), skv - band)
        k_band = k[:, start:start + band]
        v_band = v[:, start:start + band]
        q_pos = q_start + torch.arange(q_chunk, device=dev)
        k_pos = start + torch.arange(band, device=dev)
        mask = (k_pos[None, :] <= q_pos[:, None]) & \
               (k_pos[None, :] > q_pos[:, None] - window)
        s = _scores(qc[qi], k_band, "bhgqd,bkhd->bhgqk")
        s = torch.where(mask, s, _NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_band.dtype).float(),
                         v_band.float())
        outs.append(o.to(q.dtype))
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, hkv,
                                                               g, d)


def _decode_attention(q, k_cache, v_cache, n_valid):
    """Single-step decode. q: (B,1,Hkv,G,D); caches: (B,C,Hkv,D);
    n_valid: (B,) live slot count (ring buffers are full == C)."""
    d = q.shape[-1]
    c = k_cache.shape[1]
    s = _scores(_scaled(q, d ** -0.5), k_cache.to(q.dtype),
                "bqhgd,bkhd->bhgqk")                        # (B,Hkv,G,1,C)
    slot = torch.arange(c, device=q.device)
    mask = slot[None, :] < n_valid[:, None]                  # (B,C)
    s = torch.where(mask[:, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# Init (``generator`` is a torch.Generator on the target device)
# ---------------------------------------------------------------------------

def _normal(generator, shape, dtype, std):
    out = torch.randn(shape, generator=generator, device=generator.device,
                      dtype=torch.float32)
    return out.mul_(std).to(dtype)


def init_norm(generator, cfg: ArchConfig, with_bias=False):
    pdt = DTYPES[cfg.param_dtype]
    dev = generator.device
    p = {"w": torch.ones((cfg.d_model,), dtype=pdt, device=dev)}
    if with_bias or cfg.norm_type == "layernorm":
        p["b"] = torch.zeros((cfg.d_model,), dtype=pdt, device=dev)
    return p


def _apply_norm(x, p, cfg: ArchConfig):
    return norm(x, p["w"], kind=cfg.norm_type, eps=cfg.norm_eps,
                bias=p.get("b"))


def init_attention(generator, cfg: ArchConfig):
    pdt = DTYPES[cfg.param_dtype]
    dev = generator.device
    dq = cfg.n_heads * cfg.d_head
    dkv = cfg.n_kv_heads * cfg.d_head
    std = cfg.d_model ** -0.5
    p = {
        "wq": _normal(generator, (cfg.d_model, dq), pdt, std),
        "wk": _normal(generator, (cfg.d_model, dkv), pdt, std),
        "wv": _normal(generator, (cfg.d_model, dkv), pdt, std),
        "wo": _normal(generator, (dq, cfg.d_model), pdt, dq ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((dq,), dtype=pdt, device=dev)
        p["bk"] = torch.zeros((dkv,), dtype=pdt, device=dev)
        p["bv"] = torch.zeros((dkv,), dtype=pdt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.d_head,), dtype=pdt, device=dev)
        p["k_norm"] = torch.ones((cfg.d_head,), dtype=pdt, device=dev)
    return p


def write_kv_cache(k_cache, v_cache, k_new, v_new, pos):
    """Write one token into (B,C,Hkv,Dh) buffers; ring when pos >= C.
    pos: (B,) tokens already cached. Returns (k, v, n_valid) — new buffers;
    the ones passed in are left as they were.

    An indexed write of each sequence's slot ``pos % C`` (the reference's
    one-hot select exists for its sharded caches; the values are the same).
    """
    c = k_cache.shape[1]
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = (pos % c).long()
    k_cache = k_cache.clone()
    v_cache = v_cache.clone()
    k_cache[rows, idx] = k_new.to(k_cache.dtype)
    v_cache[rows, idx] = v_new.to(v_cache.dtype)
    n_valid = torch.clamp(pos + 1, max=c)
    return k_cache, v_cache, n_valid


def attention_block(cfg: ArchConfig, p, x, *, sctx: ShardCtx = NO_SHARD,
                    positions=None, kv_cache=None, cache_write: bool = True,
                    use_rope: bool = True, causal: Optional[bool] = None,
                    kv_override=None, q_chunk: Optional[int] = None,
                    kv_chunk: Optional[int] = None):
    """GQA attention. x: (B,S,D).

    ``q_chunk``/``kv_chunk`` default to ``None`` — resolved from the
    ``attention`` namespace of the tuning cache when an entry exists, and
    the historical static 512/1024 otherwise. Explicit ints are honoured.

    Modes:
      * prefill: kv_cache is None -> returns (out, (k, v)) where k/v are
        the fresh full-sequence KV (for cache construction).
      * decode: kv_cache = (k_cache, v_cache, pos) with q of length 1; the
        block writes the new token's K/V into the (ring) buffers and
        returns (out, (k_cache', v_cache')).
      * cross-attention decode: kv_cache = (k, v, n_valid),
        cache_write=False (static encoder KV — nothing is written).
      * cross-attention prefill: kv_override = (k, v) precomputed KV.
    """
    b, s, _ = x.shape
    causal = cfg.causal if causal is None else causal
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // hkv

    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    if cfg.qk_norm:
        q = norm(q, p["q_norm"], kind="rmsnorm", eps=cfg.norm_eps)
    if use_rope:
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None, :]
        q = rope(q, positions, theta=cfg.rope_theta)
    qg = q.reshape(b, s, hkv, g, dh)

    need_fresh = kv_override is None and (kv_cache is None or cache_write)
    k = v = None
    if kv_override is not None:
        k, v = kv_override
    elif need_fresh:
        k = dense(x, p["wk"], p.get("bk")).reshape(b, s, hkv, dh)
        v = dense(x, p["wv"], p.get("bv")).reshape(b, s, hkv, dh)
        if cfg.qk_norm:
            k = norm(k, p["k_norm"], kind="rmsnorm", eps=cfg.norm_eps)
        if use_rope:
            k = rope(k, positions, theta=cfg.rope_theta)

    if kv_cache is not None:
        k_cache, v_cache, meta = kv_cache
        if cache_write:
            k_cache, v_cache, n_valid = write_kv_cache(
                k_cache, v_cache, k[:, 0], v[:, 0], meta)
        else:
            n_valid = meta
        out = _decode_attention(qg, k_cache, v_cache, n_valid)
        aux_kv = (k_cache, v_cache)
    else:
        q_off = k.shape[1] - s
        if q_chunk is None or kv_chunk is None:
            tuned_q, tuned_kv = _pick_chunks(s, k.shape[1], dh, x.dtype,
                                             x.device)
            q_chunk = tuned_q if q_chunk is None else q_chunk
            kv_chunk = tuned_kv if kv_chunk is None else kv_chunk
        if cfg.sliding_window is not None and causal and \
                k.shape[1] > cfg.sliding_window:
            out = _banded_window_attention(
                qg, k, v, window=cfg.sliding_window, q_offset=q_off,
                q_chunk=q_chunk)
        else:
            out = _online_chunk_attention(
                qg, k, v, causal=causal, q_offset=q_off,
                q_chunk=q_chunk, kv_chunk=kv_chunk)
        aux_kv = (k, v)

    out = dense(out.reshape(b, s, h * dh), p["wo"])
    return out, aux_kv


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg: ArchConfig):
    pdt = DTYPES[cfg.param_dtype]
    std_in, std_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
    p = {
        "w_up": _normal(generator, (cfg.d_model, cfg.d_ff), pdt, std_in),
        "w_down": _normal(generator, (cfg.d_ff, cfg.d_model), pdt, std_out),
    }
    if cfg.mlp_type == "swiglu":
        p["w_gate"] = _normal(generator, (cfg.d_model, cfg.d_ff), pdt,
                              std_in)
    return p


def mlp_block(cfg: ArchConfig, p, x, *, sctx: ShardCtx = NO_SHARD):
    """SwiGLU or plain MLP."""
    up = dense(x, p["w_up"])
    if cfg.mlp_type == "swiglu":
        h = _act(dense(x, p["w_gate"]), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return dense(h, p["w_down"])


def init_moe(generator, cfg: ArchConfig):
    pdt = DTYPES[cfg.param_dtype]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    std_in, std_out = d ** -0.5, f ** -0.5
    return {
        "router": _normal(generator, (d, e), pdt, std_in),
        "w_gate": _normal(generator, (e, d, f), pdt, std_in),
        "w_up": _normal(generator, (e, d, f), pdt, std_in),
        "w_down": _normal(generator, (e, f, d), pdt, std_out),
    }


def _moe_dispatch(cfg: ArchConfig, p, x, cap: int):
    """Sort-based top-k dispatch, each sequence on its own. x: (B, S, D).

    Per-sequence dispatch enforces expert capacity per sequence (GShard
    'group' semantics), as the reference's ``vmap`` of
    ``_moe_dispatch_one`` does: the same stable sort, segment starts by
    ``searchsorted`` and a dump row for dropped slots, with a batch axis.
    The router is one ``dense`` for the whole batch. Returns (buf
    (B,E,cap,D), combine(y_buf) -> (B,S,D), probs (B,S,E)).
    """
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device

    logits = dense(x, p["router"]).float()                   # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties towards the lower index; a stable descending
    # sort does the same.
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    flat_expert = gate_idx.reshape(bsz, s * k)               # (B,S*k)
    flat_gate = gate_vals.reshape(bsz, s * k)
    flat_token = torch.arange(s, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = flat_token[order]                         # (B,S*k)
    sorted_gate = torch.gather(flat_gate, 1, order)

    experts = torch.arange(e, device=dev).expand(bsz, e).contiguous()
    seg_start = torch.searchsorted(sorted_expert, experts, side="left")
    pos_in_expert = torch.arange(s * k, device=dev) \
        - torch.gather(seg_start, 1, sorted_expert)
    keep = pos_in_expert < cap
    dest = torch.where(keep, sorted_expert * cap + pos_in_expert, e * cap)

    rows = torch.arange(bsz, device=dev)[:, None]
    buf = torch.zeros((bsz, e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[rows, dest] = x[rows, sorted_token]
    buf = buf[:, :-1].reshape(bsz, e, cap, d)

    def combine(y_buf):
        y_slots = y_buf.reshape(bsz, e * cap, d)
        picked = y_slots[rows, torch.clamp(dest, 0, e * cap - 1)]
        gathered = torch.where(keep[..., None], picked, 0.0)
        y = torch.zeros((bsz, s, d), dtype=x.dtype, device=dev)
        return y.index_put_((rows.expand_as(sorted_token), sorted_token),
                            gathered * sorted_gate[..., None].to(x.dtype),
                            accumulate=True)

    return buf, combine, probs


def _expert_dense(t, w):
    """Per-expert contraction ``becd,edf->becf``: one ``ops.dense_matmul``
    per expert (K1 on the card), stacked on the expert axis."""
    return torch.stack([_kops.dense_matmul(t[:, e], w[e])
                        for e in range(w.shape[0])], dim=1)


def moe_block(cfg: ArchConfig, p, x, *, sctx: ShardCtx = NO_SHARD,
              capacity_factor: Optional[float] = None):
    """Top-k MoE: per-sequence sort-based dispatch + per-expert products.

    Tokens beyond per-sequence capacity are dropped (GShard semantics).
    Returns (y, router_probs) — probs (B,S,E) feed the load-balance aux
    loss.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor
    cap = int(max(1, round(s * k / e * cf)))

    buf, combine, probs = _moe_dispatch(cfg, p, x, cap)     # (B,E,cap,D)
    h_gate = _expert_dense(buf, p["w_gate"].to(x.dtype))
    h_up = _expert_dense(buf, p["w_up"].to(x.dtype))
    h = _act(h_gate, cfg.act) * h_up
    y_buf = _expert_dense(h, p["w_down"].to(x.dtype))
    return combine(y_buf), probs
