"""LM serving engine: batched prefill + decode over the model stack.

The port of the reference's ``serve/engine.py``. ``prefill`` builds the
cache and returns last-token logits; ``decode_step`` (from
``repro_torch.models``) advances one token for the whole batch.
``generate`` is the host driver (greedy or temperature sampling) used by
``launch/serve.py``. MoE archs serve with capacity 2.0x (``serve_config``).

Everything runs under ``torch.inference_mode()``: ``ops.dense_matmul``, the
projections' route to K1, has no backward yet. The fp32 master weights are
cast to the compute dtype once per ``prefill`` / ``generate`` call and the
cast tree is passed down (the reference casts inside every jitted prefill
and decode step; the values are the same).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import default_device
from repro_torch.configs.base import ArchConfig, cache_specs
from repro_torch.models import decode_step, forward, unembed
from repro_torch.models.layers import ShardCtx, NO_SHARD
from repro_torch.models.model import _cast_params

__all__ = ["serve_config", "init_cache", "prefill", "make_decode_fn",
           "generate"]


def serve_config(cfg: ArchConfig) -> ArchConfig:
    """Inference-mode config: no remat; MoE capacity 2.0x (drop-free for
    any remotely balanced router; single-token decode is always
    lossless)."""
    kw = {"remat": False}
    if cfg.n_experts:
        kw["capacity_factor"] = min(cfg.n_experts / cfg.top_k, 2.0)
    return cfg.replace(**kw)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device=None):
    """Zero-filled decode cache (for decode-from-scratch), on ``device``
    (the card unless the caller names the CPU)."""
    dev = default_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_specs(cfg, batch, cache_len).items()}


def _prefill(cfg, params, cast, tokens, *, cache_len, sctx, frames,
             vision_embeds):
    out = forward(cfg, cast, tokens, sctx=sctx, frames=frames,
                  vision_embeds=vision_embeds, return_cache=True,
                  cache_len=cache_len)
    # the reference unembeds the prompt with the master weights
    return unembed(cfg, params, out["x"][:, -1:]), out["cache"]


@torch.inference_mode()
def prefill(cfg: ArchConfig, params, tokens, *, cache_len: int,
            sctx: ShardCtx = NO_SHARD, frames=None, vision_embeds=None):
    """Run the prompt, build the cache. Returns (last_logits, cache)."""
    return _prefill(cfg, params, _cast_params(cfg, params), tokens,
                    cache_len=cache_len, sctx=sctx, frames=frames,
                    vision_embeds=vision_embeds)


def make_decode_fn(cfg: ArchConfig, *, sctx: ShardCtx = NO_SHARD):
    @torch.inference_mode()
    def fn(params, tokens, cache):
        return decode_step(cfg, params, tokens, cache, sctx=sctx)
    return fn


def _sample(logits, generator, temperature: float):
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(cfg: ArchConfig, params, prompt_tokens, *, max_new_tokens: int,
             cache_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             sctx: ShardCtx = NO_SHARD, frames=None, vision_embeds=None):
    """Host-side batched generation loop. prompt_tokens: (B, S_prompt) on
    the device the weights lie on. Greedy (``argmax``) at temperature 0;
    else sampled with ``generator`` (a ``torch.Generator`` on that device;
    the device's default stream when None). Returns (B, max_new_tokens).

    The default ``cache_len`` holds the whole context: the prompt, the
    vision embeddings a vlm prepends, and the new tokens. (The reference's
    counts the text prompt only, so a vlm's cache drops positions its
    decode steps should attend to.)"""
    cfg = serve_config(cfg)
    b, s_prompt = prompt_tokens.shape
    if cfg.family == "vlm" and vision_embeds is not None:
        s_prompt += vision_embeds.shape[1]
    cache_len = cache_len or (s_prompt + max_new_tokens)
    cast = _cast_params(cfg, params)
    dec = make_decode_fn(cfg, sctx=sctx)

    logits, cache = _prefill(cfg, params, cast, prompt_tokens,
                             cache_len=cache_len, sctx=sctx, frames=frames,
                             vision_embeds=vision_embeds)
    tok = _sample(logits[:, -1], generator, temperature)[:, None]
    outs = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = dec(cast, tok, cache)
        tok = _sample(logits[:, -1], generator, temperature)[:, None]
        outs.append(tok)
    return torch.cat(outs, dim=1)
