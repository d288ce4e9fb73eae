"""AdamW with dtype-configurable moment storage (fp32 / bf16 / int8-block).

The port of the reference's ``train/optimizer.py``: the same update, the
same moment dtypes and the same int8 storage (blockwise symmetric
quantization, ``parallel.collectives``; the second moment stored as
sqrt(v)). A tree is a nested ``dict`` of tensors; a ``QTensor`` is a leaf
of the moment trees.

``adamw_update`` and ``clip_by_global_norm`` write their results into the
tensors they are given and return those trees (the reference returns new
trees): no second copy of a 1.7B-parameter state is made, the counterpart
of the reference's donated buffers.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import is_dtensor
from repro_torch.parallel.collectives import quantize_int8, dequantize_int8
from repro_torch.parallel.sharding import from_flat_rows, to_flat_rows

__all__ = ["adamw_init", "adamw_update", "global_norm", "clip_by_global_norm",
           "cosine_lr", "QTensor"]


@dataclasses.dataclass
class QTensor:
    """int8 blockwise-quantized tensor leaf (moment storage): ``q`` int8
    (n_blocks, block), ``scale`` fp32 (n_blocks,), the logical ``shape``
    and element count ``n``. Its children for a checkpoint are ``q`` and
    ``scale`` (``tree_flatten``), named ``0`` and ``1`` as the reference's
    pytree class flattens."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple
    n: int

    def tree_flatten(self):
        return (self.q, self.scale), (self.shape, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, scale = children
        return cls(q, scale, tuple(aux[0]), int(aux[1]))

    def dequantize(self, dtype=torch.float32, like=None) -> torch.Tensor:
        """The stored tensor. On DTensors (``q`` and ``scale`` rows placed
        by ``state_specs``) each rank decodes its own rows and one
        all-to-all takes the values to ``like``'s placements (those of the
        parameter): no rank holds the whole tensor."""
        if is_dtensor(self.q):
            rows = (self.q.to_local().float()
                    * self.scale.to_local()[:, None])
            return from_flat_rows(rows, self.q, like).to(dtype)
        return dequantize_int8(self.q, self.scale, (self.shape, self.n),
                               dtype=dtype)

    @classmethod
    def quantize(cls, x: torch.Tensor, like=None) -> "QTensor":
        """``x`` stored in int8 blocks. On a DTensor ``like`` (the
        ``QTensor`` it replaces) gives the rows' placements: one
        all-to-all brings each rank the values of its own rows, which it
        quantizes alone. The blocks are those of one device, since a row
        is a block of the flattened tensor."""
        if is_dtensor(x):
            from torch.distributed.tensor import DTensor
            if like is None:
                raise ValueError("a DTensor is quantized into the rows of "
                                 "the QTensor it replaces (like=)")
            rows = to_flat_rows(x.float(), like.q)
            q, scale, _ = quantize_int8(rows, block=rows.shape[1])

            def placed(t, as_):
                return DTensor.from_local(t, as_.device_mesh, as_.placements,
                                          run_check=False, shape=as_.shape,
                                          stride=as_.stride())
            return cls(placed(q, like.q), placed(scale, like.scale),
                       like.shape, like.n)
        q, scale, (shape, n) = quantize_int8(x)
        return cls(q, scale, tuple(shape), n)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _store(x, dtype: str, like=None):
    """``x`` in the moment dtype; ``like`` is the leaf it replaces (the
    rows' layout of an int8 moment on DTensors)."""
    if dtype == "int8":
        return QTensor.quantize(x, like)
    return x.to(_dtype(dtype))


def _load(x, like=None):
    """A moment in fp32; ``like`` (the parameter) places an int8 moment on
    DTensors."""
    if isinstance(x, QTensor):
        return x.dequantize(like=like)
    return x.float()


def _store_v(x, dtype: str, like=None):
    """Second moment: int8 stores sqrt(v) — v spans the SQUARE of the
    gradient range, which blockwise int8 cannot hold (small-v coordinates
    underflow to 0 and the update explodes). sqrt halves the dynamic
    range."""
    if dtype == "int8":
        return QTensor.quantize(torch.sqrt(x), like)
    return x.to(_dtype(dtype))


def _load_v(x, like=None):
    if isinstance(x, QTensor):
        r = x.dequantize(like=like)
        return r * r
    return x.float()


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of same-structured nested dicts (a
    ``QTensor`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    """The leaves of nested dicts, in ``_tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _device(tree) -> torch.device:
    leaf = _leaves(tree)[0]
    return (leaf.q if isinstance(leaf, QTensor) else leaf).device


def adamw_init(params, state_dtype: str = "float32"):
    """Zero moments for ``params`` in ``state_dtype`` (``float32``,
    ``bfloat16`` or ``int8``) and a 0-d int32 step, on the params'
    device; distinct buffers for m and v."""
    def fresh(store):
        return _tree_map(lambda p: store(
            torch.zeros_like(p, dtype=torch.float32), state_dtype), params)
    return {"m": fresh(_store), "v": fresh(_store_v),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def _assign(old, new):
    """Write ``new`` into ``old`` (a tensor or a ``QTensor``); returns
    ``old``."""
    if isinstance(old, QTensor):
        old.q.copy_(_placed_as(new.q, old.q))
        old.scale.copy_(_placed_as(new.scale, old.scale))
    else:
        old.copy_(_placed_as(new, old))
    return old


def _placed_as(new, old):
    """``new`` redistributed to ``old``'s placements (DTensors)."""
    if is_dtensor(old) and tuple(new.placements) != tuple(old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def adamw_update(params, grads, opt_state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, state_dtype: str = "float32"):
    """One AdamW step, in place: ``params`` and ``opt_state``'s tensors are
    overwritten leaf by leaf. Returns (params, opt_state)."""
    step = opt_state["step"] + 1
    stepf = step.float()
    b1c = 1.0 - torch.pow(b1, stepf)
    b2c = 1.0 - torch.pow(b2, stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=step.device)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = _load(m, p) * b1 + g32 * (1 - b1)
        v32 = _load_v(v, p) * b2 + g32 * g32 * (1 - b2)
        mh = m32 / b1c
        vh = v32 / b2c
        # trust-region clip: bounds the per-coordinate step when quantized
        # moments lose low bits (inert for fp32: |m/sqrt(v)| <~ 3 anyway)
        adam = torch.clamp(mh / (torch.sqrt(vh) + eps), -5.0, 5.0)
        delta = adam + weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        _assign(p, new_p)
        _assign(m, _store(m32, state_dtype, m))
        _assign(v, _store_v(v32, state_dtype, v))

    _tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"].copy_(step)
    return params, opt_state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale ``tree``'s tensors in place by min(1, max_norm / (norm +
    1e-9)), computed in fp32, each leaf rounded back to its dtype. Returns
    (tree, norm)."""
    norm = global_norm(tree)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    _tree_map(lambda x: x.copy_((x.float() * factor).to(x.dtype)), tree)
    return tree, norm


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor_frac * peak`` at ``total``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = peak * (step + 1.0) / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 *
                  (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
