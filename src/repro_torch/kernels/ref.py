"""Plain PyTorch oracles for the kernels in this package.

The counterparts of the reference's ``repro.kernels.ref``: what the kernels
are held against, on the CPU by the tests and on the GPU by ``chip_smoke.py``
("strictly compared with the sequential code results for any precision
problems", as the paper puts it). ``flash_attention_ref`` arrives with the
attention kernel.
"""

from __future__ import annotations

import torch

from repro_torch import accum_dtype, exact_matmul_settings

__all__ = ["matmul_ref", "matmul_naive_ref"]


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
