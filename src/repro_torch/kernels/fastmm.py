"""Strassen fast matmul over the hand-written dense kernels.

The port of the reference's ``repro/kernels/fastmm.py``. Above a
card-dependent crossover size, one Strassen level trades 8 half-size
multiplies for 7 (12.5 % of the operations a level) at the price of
O(n^2) operand sums and about one bit of accuracy a level (D'Alberto's
fast multiply, PAPERS.md).

``strassen_matmul`` / ``strassen_square`` recurse on ``(..., n, n)``
tensors:

  * every leaf is ``ops.matmul`` — K1 (``matmul_cuda``) on a CUDA tensor,
    its plain version on a CPU tensor, with the tuning cache's tiles — and
    never ``torch.matmul``: a depth-L multiply is exactly 7^L K1 launches
    (one per leaf for a whole stack: the stack is a grid axis of K1);
  * an odd sub-problem pads one zero row and column at its own level
    (``F.pad``) and slices them off after the combine; the leaves pad to
    their own tiles inside ``ops.matmul``;
  * the recursion stops at the crossover or the depth cap, whichever comes
    first (``autotune.fastmm_config``: the ``fastmm`` cache namespace),
    and falls through to one dense leaf;
  * the operand sums and the combine are PyTorch elementwise ops, as the
    reference leaves them to XLA outside its kernels.

Accuracy contract: dense routes are bit-exact re-orderings of the same
kernel math; Strassen is not — its combine adds grow the forward-error
constant by about one bit a level. ``error_budget`` is the single source of
the resulting tolerance: the dense floors scaled by ``2**levels``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import autotune

__all__ = ["strassen_matmul", "strassen_square", "plan_levels",
           "error_budget", "DENSE_BUDGET"]

#: The dense routes' empirical vs-f64 tolerance floors (rtol, atol) per dtype
#: name. ``error_budget`` scales these by the Strassen level count; dense
#: comparisons use them as they are (levels=0). A dtype without an entry
#: (float16) takes the float32 floors plus its own eps-scaled term.
DENSE_BUDGET = {
    "float64": (1e-12, 1e-14),
    "float32": (2e-3, 1e-5),
    "bfloat16": (0.15, 0.05),
}


def error_budget(dtype, *, levels: int = 0, n: int = 1,
                 mults: int = 1) -> tuple:
    """(rtol, atol) error budget vs an f64 reference for one route.

    ``levels=0`` is the dense budget (the long-standing floors, with an
    eps*sqrt(n)*mults forward-error term for problems large or deep enough
    to exceed them); each Strassen level doubles both bounds. ``mults`` is
    the number of chained multiplies the result went through (a p-th power
    by binary powering does ``bit_length(p)-1`` squarings plus
    ``popcount(p)-1`` combines). ``dtype`` is a ``torch.dtype`` or its name.
    """
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    eps = float(torch.finfo(dtype).eps)
    name = str(dtype).removeprefix("torch.")
    rtol0, atol0 = DENSE_BUDGET.get(name, (2e-3, 1e-5))
    mults = max(int(mults), 1)
    growth = 2.0 ** max(int(levels), 0)
    rtol = max(rtol0, 16.0 * eps * math.sqrt(max(int(n), 1)) * mults) * growth
    atol = max(atol0, 16.0 * eps * mults) * growth
    return rtol, atol


def _resolve(dtype, levels, crossover, leaf_blocks, backend=None):
    """Fill ``None`` knobs from the tuning cache's ``fastmm`` namespace."""
    if levels is None or crossover is None or leaf_blocks is None:
        c_cfg, l_cfg, b_cfg = autotune.fastmm_config(dtype, backend)
        levels = l_cfg if levels is None else levels
        crossover = c_cfg if crossover is None else crossover
        leaf_blocks = b_cfg if leaf_blocks is None else leaf_blocks
    return int(levels), int(crossover), leaf_blocks


def plan_levels(n: int, levels: Optional[int] = None,
                crossover: Optional[int] = None, dtype=None) -> int:
    """Recursion depth ``strassen_matmul`` will actually use for size n.

    Mirrors the recursion's stopping rule exactly (depth cap, crossover
    fall-through, n < 2) so tests and callers can compute the matching
    ``error_budget`` without re-deriving it.
    """
    levels, crossover, _ = _resolve(dtype, levels, crossover, ())
    n, used = int(n), 0
    while used < levels and n > crossover and n >= 2:
        n = (n + 1) // 2
        used += 1
    return used


def _strassen(a, b, levels: int, crossover: int, leaf: Callable):
    n = a.shape[-1]
    if levels <= 0 or n <= crossover or n < 2:
        return leaf(a, b)
    m = n + (n % 2)
    if m != n:                      # pad to the next even size, this level only
        a = F.pad(a, (0, 1, 0, 1))
        b = F.pad(b, (0, 1, 0, 1))
    h = m // 2
    a11, a12 = a[..., :h, :h], a[..., :h, h:]
    a21, a22 = a[..., h:, :h], a[..., h:, h:]
    b11, b12 = b[..., :h, :h], b[..., :h, h:]
    b21, b22 = b[..., h:, :h], b[..., h:, h:]
    rec = functools.partial(_strassen, levels=levels - 1,
                            crossover=crossover, leaf=leaf)
    m1 = rec(a11 + a22, b11 + b22)
    m2 = rec(a21 + a22, b11)
    m3 = rec(a11, b12 - b22)
    m4 = rec(a22, b21 - b11)
    m5 = rec(a11 + a12, b22)
    m6 = rec(a21 - a11, b11 + b12)
    m7 = rec(a12 - a22, b21 + b22)
    c = torch.cat(
        [torch.cat([m1 + m4 - m5 + m7, m3 + m5], dim=-1),
         torch.cat([m2 + m4, m1 - m2 + m3 + m6], dim=-1)], dim=-2)
    if m != n:
        c = c[..., :n, :n]
    return c


def _default_leaf(leaf_blocks, out_dtype) -> Callable:
    # ops.matmul is the whole dispatch in one call: the tuning cache's tiles,
    # padding to them, K1 on a CUDA tensor (its plain version on a CPU one),
    # leading stack dims as a grid axis. Imported here: ops imports this
    # module for the chain's fast route.
    from repro_torch.kernels import ops as kops
    return functools.partial(kops.matmul, blocks=leaf_blocks,
                             out_dtype=out_dtype)


def strassen_matmul(a: torch.Tensor, b: torch.Tensor, *,
                    levels: Optional[int] = None,
                    crossover: Optional[int] = None,
                    leaf_blocks=None, out_dtype=None,
                    leaf: Optional[Callable] = None) -> torch.Tensor:
    """C = A @ B by Strassen recursion over the dense K1 leaves.

    Operands must be square with identical shapes (the squaring chain's
    use); leading stack dims ride the quadrant slicing and reach each leaf
    as one stacked launch. ``levels`` / ``crossover`` / ``leaf_blocks``
    default to the tuning cache's ``fastmm`` config for ``a.dtype`` on
    ``a``'s device type (``levels=0`` or ``crossover >= n`` is one dense
    leaf call). ``leaf`` replaces the dense leaf (tests count leaves with
    it). ``a`` and ``b`` are never written; the result is a new tensor.
    """
    if a.shape != b.shape or a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"strassen_matmul needs same-shape square "
                         f"operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    levels, crossover, leaf_blocks = _resolve(a.dtype, levels, crossover,
                                              leaf_blocks, a.device.type)
    if leaf is None:
        leaf = _default_leaf(leaf_blocks, out_dtype)
    return _strassen(a, b, levels, crossover, leaf)


def strassen_square(a: torch.Tensor, **kwargs) -> torch.Tensor:
    """C = A @ A via ``strassen_matmul`` (the squaring chain's face)."""
    return strassen_matmul(a, a, **kwargs)
