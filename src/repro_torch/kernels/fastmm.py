"""Error budgets of the multiply routes.

Only the accuracy contract lives here so far: ``DENSE_BUDGET`` and
``error_budget``, the port's own copy of the reference's
``repro.kernels.fastmm`` arithmetic (the port imports nothing of the
reference). The Strassen recursion itself is ported into this file later;
until then the ``fastmm`` backend names are unknown to
``core.matpow.matmul_backend``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["error_budget", "DENSE_BUDGET"]

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
