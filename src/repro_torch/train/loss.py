"""Chunked cross-entropy — never materializes a (B, S, V) logits tensor.

The port of the reference's ``train/loss.py``. CE is summed over sequence
chunks, each chunk's body run under ``torch.utils.checkpoint`` when grad is
enabled (the reference's ``jax.checkpoint`` with ``nothing_saveable``), so
no chunk's (B, chunk, V) logits stay alive for the backward: it recomputes
the chunk's unembed.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import unembed

__all__ = ["chunked_cross_entropy"]


def chunked_cross_entropy(cfg: ArchConfig, params, x, targets, *,
                          chunk: int = 512, mask=None) -> torch.Tensor:
    """Mean next-token CE. x: (B, S, D) pre-logits; targets: (B, S) int.

    mask: optional (B, S) {0,1}; defaults to all ones. ``chunk`` is halved
    until it divides S.
    """
    b, s, _ = x.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)

    def body(xs, ts, ms):
        logits = unembed(cfg, params, xs)                  # (B, chunk, V) f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ts.long()[..., None])[..., 0]
        ce = (lse - gold) * ms
        return torch.sum(ce), torch.sum(ms)

    run = body
    if torch.is_grad_enabled():
        run = lambda *a: checkpoint(body, *a, use_reentrant=False)  # noqa
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, chunk):
        t, c = run(x[:, lo:lo + chunk], targets[:, lo:lo + chunk],
                   mask[:, lo:lo + chunk].float())
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)
