"""Plain PyTorch oracles for the kernels in this package.

The counterparts of the reference's ``repro.kernels.ref``: what the kernels
are held against, on the CPU by the tests and on the GPU by ``chip_smoke.py``
("strictly compared with the sequential code results for any precision
problems", as the paper puts it).
"""

from __future__ import annotations

import torch

from repro_torch import accum_dtype, exact_matmul_settings

__all__ = ["matmul_ref", "matmul_naive_ref", "flash_attention_ref",
           "row_relative_error"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """fp32-accumulating matmul oracle (f64 operands accumulate in f64):
    widen both operands to the accumulation dtype, multiply, cast once."""
    out_dtype = out_dtype or a.dtype
    acc = accum_dtype(a.dtype)
    exact_matmul_settings()
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


def matmul_naive_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The paper's naive triple loop, vectorised one level: row i of C is
    sum_k a[i, k] * b[k, :]. For tiny tests only — it materialises an
    (M, K, N) tensor."""
    return (a[:, :, None] * b[None, :, :]).sum(dim=1).to(a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None,
                        scale=None) -> torch.Tensor:
    """Naive full-materialisation attention oracle.

    q: (..., Sq, D), k/v: (..., Skv, D) with the same leading dims (the
    reference takes one (Sq, D) slice; the leading dims here are what its
    ``jax.vmap`` would map over). Scores and softmax in fp32 — float64
    inputs too, as the reference computes them — and the result in
    ``q.dtype``. Queries are right-aligned against the keys (``q_pos = row
    + Skv - Sq``); the causal mask keeps ``k_pos <= q_pos``, a window keeps
    ``k_pos > q_pos - window``. A query row that sees no key returns 0.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    exact_matmul_settings()
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)     # rows with no visible key
    return torch.matmul(probs, v.float()).to(q.dtype)


def row_relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over the rows (last axis), of a row's largest
    ``|got - want|`` over that row's largest ``|want|``.

    The yardstick for outputs whose scale varies by row, as attention's
    does: row 0 of a causal output is v[0] itself, while a row that
    averages n keys is about n^-1/2 of that, so an error taken relative to
    the whole output's largest entry may be as large as a typical late
    entry and would pass a kernel that dropped a KV tile. A row whose
    ``want`` is all zero must match it exactly (its ratio is inf otherwise).
    """
    diff = (got.double() - want.double()).abs().amax(-1)
    peak = want.double().abs().amax(-1)
    ratio = torch.where(diff == 0, torch.zeros_like(diff), diff / peak)
    return ratio.max().item()
