"""Train-step builder: microbatch accumulation + AdamW + clip.

The port of the reference's ``train/train_step.py``. ``make_train_step(cfg,
...)`` returns ``step(state, batch) -> (state, metrics)``. Gradients come
from ``torch.autograd.grad`` through the model's forward (every projection
K1 in both directions on the card), accumulated in fp32 over ``accum``
microbatches by a Python loop (the reference's ``lax.scan``).

The step updates the state's tensors in place (params, moments, step
counter): no second copy of a 1.7B-parameter state is made. That is the
counterpart of the reference's ``jax.jit(step, donate_argnums=0)``; the
``state`` returned is the one passed in. The metrics are 0-d tensors on the
device (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``); nothing in the
step waits for the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import is_dtensor
from repro_torch.configs.base import ArchConfig
from repro_torch.models import forward
from repro_torch.models.layers import ShardCtx, NO_SHARD
from repro_torch.models.model import _cast_params
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (_leaves, _tree_map, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         cosine_lr)

__all__ = ["make_train_step", "init_train_state", "loss_and_metrics",
           "AUX_COEF"]

AUX_COEF = 0.01        # MoE load-balance coefficient (Switch default-ish)


def init_train_state(cfg: ArchConfig, params):
    return {"params": params,
            "opt": adamw_init(params, cfg.optimizer_state_dtype)}


def loss_and_metrics(cfg: ArchConfig, params, batch, *,
                     sctx: ShardCtx = NO_SHARD):
    out = forward(cfg, params, batch["tokens"],
                  frames=batch.get("frames"),
                  vision_embeds=batch.get("vision_embeds"), sctx=sctx)
    x = out["x"]
    if cfg.family == "vlm" and cfg.n_vision_tokens:
        x = x[:, cfg.n_vision_tokens:]
    targets = sctx.shard(batch["targets"], sctx.dp, None)
    ce = chunked_cross_entropy(cfg, params, x, targets)
    loss = ce + AUX_COEF * out["aux"]
    return loss, {"ce": ce, "aux": out["aux"]}


def _split_microbatches(batch, accum: int) -> list:
    """``accum`` microbatches: microbatch i is the i-th slice of the global
    rows. A DTensor batch (sharded over dp) is gathered once, and each
    microbatch placed back as the batch was (each rank keeps its rows of
    the slice: no collective)."""
    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        full = v.full_tensor() if is_dtensor(v) else v
        parts = full.reshape((accum, full.shape[0] // accum)
                             + full.shape[1:])
        for i in range(accum):
            out[i][k] = parts[i] if full is v else _like(parts[i], v)
    return out


def _like(part, v):
    """``part`` (every rank's alike) placed as the DTensor ``v``."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = v.device_mesh
    return DTensor.from_local(part, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh,
                                                            v.placements)


def make_train_step(cfg: ArchConfig, *, sctx: ShardCtx = NO_SHARD,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, clip_norm: float = 1.0,
                    weight_decay: float = 0.1, accum: Optional[int] = None,
                    cast_params: str = "step"):
    """``cast_params``:
      * "step"       — cast the fp32 masters to the compute dtype ONCE per
        step, outside the accumulation loop, and take the gradients of that
        copy (in the compute dtype, then accumulated in fp32);
      * "microbatch" — the reference's naive placement: the cast lives
        inside the loss, every microbatch, and the gradients are the
        masters' own.
    """
    accum = accum or cfg.grad_accum
    if cast_params not in ("step", "microbatch"):
        raise ValueError(f"unknown cast_params {cast_params!r}")

    def grads_of(tree, leaves, mb):
        with torch.enable_grad():
            loss, metrics = loss_and_metrics(cfg, tree, mb, sctx=sctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def step(state, batch):
        params = state["params"]
        source = _cast_params(cfg, params) if cast_params == "step" \
            else params
        tree = _tree_map(lambda p: p.detach().requires_grad_(), source)
        leaves = _leaves(tree)
        if accum > 1:
            g_sum = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            loss = leaves[0].new_zeros((), dtype=torch.float32)
            for mb in _split_microbatches(batch, accum):
                mb_loss, metrics, grads = grads_of(tree, leaves, mb)
                for a, g in zip(g_sum, grads):
                    a.add_(g.float())
                loss = loss + mb_loss
                del grads
            grads = [g.div_(accum) for g in g_sum]
            loss = loss / accum
        else:
            loss, metrics, grads = grads_of(tree, leaves, batch)
        del tree, leaves, source
        it = iter(grads)
        grads = _tree_map(lambda _: next(it), params)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = cosine_lr(state["opt"]["step"], peak=peak_lr, warmup=warmup,
                       total=total_steps)
        adamw_update(params, grads, state["opt"], lr=lr,
                     weight_decay=weight_decay,
                     state_dtype=cfg.optimizer_state_dtype)
        out = dict(metrics)
        out.update(loss=loss, grad_norm=gnorm, lr=lr)
        return state, out

    return step

