"""Log-depth prefix products — the paper's doubling trick, generalized.

The port of the reference's ``core/scan.py``. Exponentiation by squaring
computes A^n in O(log n) multiplies because matrix multiplication is
associative. The same insight gives *all* prefix products of a chain A_1,
A_2, ..., A_T in O(log T) parallel depth (Hillis-Steele doubling), which is
how the Mamba-2 SSD blocks of ``mamba2-130m`` / ``zamba2-1.2b`` evaluate
their inter-chunk state recurrence (``repro_torch.models.ssm``).

``prefix_products``   : cumulative products of a stack of matrices, log depth.
``prefix_scan``       : generic inclusive scan with any associative combine,
                        by doubling, over a tensor or a tuple / list / dict
                        of tensors.
``decay_prefix``      : the scalar/diagonal specialization used by SSD
                        (cumulative products of per-step decay factors).

The products of ``prefix_products`` are ``torch.matmul`` calls, as the
reference's are ``jnp.matmul`` outside any kernel; they run with
``exact_matmul_settings()`` in force (fp32 accumulation, no TF32).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import accum_dtype, exact_matmul_settings

__all__ = ["prefix_scan", "prefix_products", "decay_prefix"]


def _flatten(x):
    """(leaves, rebuild) of a tensor or a tuple / list / dict of tensors."""
    if isinstance(x, torch.Tensor):
        return [x], lambda ls: ls[0]
    if isinstance(x, dict):
        keys = list(x)
        return [x[k] for k in keys], lambda ls: dict(zip(keys, ls))
    if isinstance(x, (tuple, list)):
        kind = type(x)
        return list(x), lambda ls: kind(ls)
    raise TypeError(f"prefix_scan takes a tensor or a tuple, list or dict of "
                    f"tensors, got {type(x).__name__}")


def prefix_scan(x, combine: Callable, axis: int = 0):
    """Inclusive scan along ``axis`` using Hillis–Steele doubling.

    ``x`` may be a tensor or a tuple / list / dict of tensors sharing the
    scan-axis length (e.g. the SSD inter-chunk operator (decay,
    state-increment)). ``combine(older, newer)`` must be associative and
    return the same structure; it receives slices where ``older``
    accumulates values ending ``offset`` steps earlier. Depth is
    ceil(log2 T) combines.
    """
    leaves, rebuild = _flatten(x)
    moved = [torch.movedim(leaf, axis, 0) for leaf in leaves]
    t = moved[0].shape[0]

    offset = 1
    while offset < t:
        older = rebuild([leaf[:-offset] for leaf in moved])
        newer = rebuild([leaf[offset:] for leaf in moved])
        combined = _flatten(combine(older, newer))[0]
        moved = [torch.cat([leaf[:offset], c], dim=0)
                 for leaf, c in zip(moved, combined)]
        offset <<= 1
    return rebuild([torch.movedim(leaf, 0, axis) for leaf in moved])


def prefix_products(mats: torch.Tensor, *, axis: int = 0,
                    reverse: bool = False) -> torch.Tensor:
    """All cumulative matrix products P_i = A_i @ A_{i-1} @ ... @ A_1.

    ``mats``: (..., T, m, m) stack along ``axis`` (default leading). Returns
    the same shape where slot i holds the product of slots [0..i] (or
    [i..T-1] if ``reverse``). log2(T) batched-matmul depth.

    Convention: newer matrices multiply from the LEFT (state_i = A_i @
    state_{i-1}). Sub-fp32 chains (bf16 / f16) are multiplied at fp32
    (``accum_dtype``) and cast back after each product, as the reference's
    ``preferred_element_type`` does.
    """
    if mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"prefix_products needs square matrices, got "
                         f"{tuple(mats.shape)}")
    exact_matmul_settings()
    acc = accum_dtype(mats.dtype)

    def product(left, right):
        return torch.matmul(left.to(acc), right.to(acc)).to(mats.dtype)

    if reverse:
        flipped = torch.flip(mats, dims=(axis,))
        out = prefix_scan(flipped, lambda older, newer: product(older, newer),
                          axis=axis)
        return torch.flip(out, dims=(axis,))
    # newer @ older: the later matrix applies after (left of) the earlier.
    return prefix_scan(mats, lambda older, newer: product(newer, older),
                       axis=axis)


def decay_prefix(log_decay: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Cumulative sums of log-decays (= log of cumulative decay products):
    the diagonal specialization of :func:`prefix_products`, kept in log
    space for stability over long chains."""
    return torch.cumsum(log_decay, dim=axis)
