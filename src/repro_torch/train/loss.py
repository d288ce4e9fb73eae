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

from repro_torch import is_dtensor
from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import unembed

__all__ = ["chunked_cross_entropy"]


def _token_ce(logits, ts, ms):
    """Masked CE per token: (B, chunk)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ts.long()[..., None])[..., 0]
    return (lse - gold) * ms


def _rows_local(fn, logits, ts, ms):
    """``fn`` on each rank's rows of DTensors placed as the targets ``ts``
    are (the batch over dp): the logits' vocab dim is gathered for it
    (DTensor's vocab-sharded gather is not used). Returns a DTensor placed
    as ``ts``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = ts.device_mesh, ts.placements
    row = [p if p == Shard(0) else Replicate() for p in pl]
    out = fn(*(t.redistribute(mesh, row).to_local()
               for t in (logits, ts, ms)))
    return DTensor.from_local(out, mesh, row, run_check=False)


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
        mask = torch.ones_like(targets, dtype=torch.float32)

    def body(xs, ts, ms):
        logits = unembed(cfg, params, xs)                  # (B, chunk, V) f32
        if is_dtensor(logits):
            ce = _rows_local(_token_ce, logits, ts, ms)
        else:
            ce = _token_ce(logits, ts, ms)
        return torch.sum(ce), torch.sum(ms)

    run = body
    if torch.is_grad_enabled():
        run = lambda *a: checkpoint(body, *a, use_reentrant=False)  # noqa
    # new_zeros: a replicated 0-d DTensor when x is a DTensor
    tot = x.new_zeros((), dtype=torch.float32)
    cnt = x.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, chunk):
        t, c = run(x[:, lo:lo + chunk], targets[:, lo:lo + chunk],
                   mask[:, lo:lo + chunk].float())
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)
