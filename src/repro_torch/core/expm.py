"""Matrix exponential e^A by scaling-and-squaring — the scientific application.

The port of the reference's ``repro/core/expm.py``. The standard algorithm
(Higham 2005) is built on exactly the paper's squaring chain: approximate
e^{A/2^s} with a Pade rational, then square s times.
"""

from __future__ import annotations

import torch

from repro_torch import exact_matmul_settings
from repro_torch.core import matpow

__all__ = ["expm"]

# Pade-13 coefficients (Higham, "The Scaling and Squaring Method for the
# Matrix Exponential Revisited", SIAM J. Matrix Anal. 2005).
_PADE13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0, 670442572800.0,
    33522128640.0, 1323241920.0, 40840800.0, 960960.0, 16380.0, 182.0, 1.0,
)
_THETA13 = 5.371920351148152  # 1-norm threshold for Pade-13


def _pade13(a: torch.Tensor, ident: torch.Tensor):
    b = _PADE13
    a2 = a @ a
    a4 = a2 @ a2
    a6 = a2 @ a4
    u = a @ (a6 @ (b[13] * a6 + b[11] * a4 + b[9] * a2)
             + b[7] * a6 + b[5] * a4 + b[3] * a2 + b[1] * ident)
    v = (a6 @ (b[12] * a6 + b[10] * a4 + b[8] * a2)
         + b[6] * a6 + b[4] * a4 + b[2] * a2 + b[0] * ident)
    return u, v


def expm(a: torch.Tensor, *, max_squarings: int = 32,
         backend: str = "torch") -> torch.Tensor:
    """Matrix exponential via Pade-13 + the paper's repeated-squaring chain.

    Supports stacks (..., n, n). Computes in float32 for f32/bf16/f16 input
    and float64 for f64, and casts back once at the end. The number of
    squarings is data dependent — per matrix, s = ceil(log2(|A|_1 / theta))
    clipped to ``max_squarings`` — so the chain squares to the stack's
    largest s, read with ``int(s.max())`` (ONE device-to-host
    synchronisation), and masks finished members with ``torch.where``.

    ``backend`` selects the squaring-chain multiply route, same names as
    :func:`repro_torch.core.matpow.matmul_backend`; ``"cuda_chain"`` pads
    the Pade result once, squares on the padded buffer through the tiered
    squaring kernels, and un-pads once at the end. The small fixed Pade
    polynomial (6 matmuls) and the solve stay library calls
    (``torch.matmul``, ``torch.linalg.solve``) as the reference leaves them
    to its compiler — they are not a chain.
    """
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expm needs square matrices, got {tuple(a.shape)}")
    if a.shape[-1] < 1:
        raise ValueError(f"expm needs matrices with n >= 1, got "
                         f"{tuple(a.shape)}")
    dtype = a.dtype
    compute = a.to(torch.float64 if dtype == torch.float64 else torch.float32)
    exact_matmul_settings()

    norm = torch.linalg.matrix_norm(compute, ord=1, keepdim=True)
    # s = max(0, ceil(log2(norm / theta))) squarings, clipped to max_squarings.
    s = torch.clamp(torch.ceil(torch.log2(norm / _THETA13)), min=0.0)
    s = torch.clamp(s, max=float(max_squarings)).to(torch.int32)
    scaled = compute / torch.pow(2.0, s.to(compute.dtype))

    ident = torch.eye(a.shape[-1], dtype=compute.dtype,
                      device=a.device).expand(compute.shape)
    u, v = _pade13(scaled, ident)
    # r = (v - u)^-1 (v + u)
    r = torch.linalg.solve(v - u, v + u)

    # The masked loop needs a squaring's operand after the squaring, so the
    # chain must not reuse operand buffers: donate=False.
    chain = matpow.chain_for(r, backend, donate=False)
    if chain is not None:
        square = chain.square
        r = chain.pad(r)
    else:
        mm = matpow.matmul_backend(backend)
        square = lambda x: mm(x, x)

    s_max = int(s.max())  # stack: square to the max, masking finished ones
    for i in range(s_max):
        # torch.where, NOT multiply-masking: a finished member's wasted
        # extra squaring can overflow to inf in fp32, and 0 * inf = NaN
        # would corrupt its already-correct result. (i < s) broadcasts
        # (..., 1, 1).
        r = torch.where(i < s, square(r), r)
    if chain is not None:
        r = chain.unpad(r)
    return r.to(dtype)
