"""Stacked squaring chains — the paper's "different sizes and different
powers" regime.

The port of the reference's ``repro/core/batched.py``. One matrix at a time
leaves the card idle on small-n traffic; ``BatchedMatmulChain`` is the
stacked (B, n, n) form of ``ops.MatmulChain``:

  * the whole stack is padded to tile multiples ONCE at chain entry
    (zero-padding is closed under multiplication, per matrix);
  * every squaring is ONE kernel launch over the stack — the stack is a grid
    axis of the squaring kernels — between two buffers the chain owns;
  * the stack is un-padded once at exit.

``batched_matpow`` drives the binary exponentiation loop over it; the
serving engine builds its bucket executables from these entry points.
"""

from __future__ import annotations

import torch

from repro_torch.core import matpow as _matpow
from repro_torch.kernels import ops as _kops

__all__ = ["BatchedMatmulChain", "batched_matpow", "batched_expm"]


class BatchedMatmulChain(_kops.MatmulChain):
    """Fused executor for a chain of same-shape squarings over a (B, n, n)
    stack: pad the stack once, one launch per stacked squaring, unpad once.

    Everything (tile selection, squaring-tier policy, buffer ping-pong) is
    inherited from :class:`~repro_torch.kernels.ops.MatmulChain`, whose
    kernels already take the stack as a grid axis; this class pins the
    leading batch dimension so shape mistakes fail at the chain boundary.

    ``square(x)`` CONSUMES ``x`` when the chain donates; ``pad`` protects
    the caller's tensor exactly like the per-matrix chain does.
    """

    def __init__(self, batch: int, n: int, dtype, *, blocks=None,
                 donate: bool = True, device=None, fast=False):
        if not isinstance(batch, int) or isinstance(batch, bool) or batch < 1:
            raise ValueError(f"batched chains need a static batch >= 1, "
                             f"got {batch!r}")
        super().__init__(n, dtype, blocks=blocks, donate=donate,
                         device=device, fast=fast)
        self.batch = batch

    # -- chain boundary ----------------------------------------------------
    def pad(self, a: torch.Tensor) -> torch.Tensor:
        """Zero-pad (B, n, n) -> (B, P, P). Called once per chain."""
        if a.ndim != 3 or a.shape[0] != self.batch:
            raise ValueError(
                f"batched chain expects a ({self.batch}, {self.n}, {self.n}) "
                f"stack, got shape {tuple(a.shape)}")
        return super().pad(a)


def batched_matpow(a: torch.Tensor, p: int, *, backend: str = "torch") -> torch.Tensor:
    """A_i^p for every matrix of a stacked (B, n, n) operand.

    The binary-exponentiation chain of
    :func:`repro_torch.core.matpow.matpow_binary` executed stack-at-once:
    floor(log2 p) stacked squarings plus popcount(p)-1 stacked combines,
    each ONE launch for all B matrices. ``backend`` follows
    :func:`repro_torch.core.matpow.matmul_backend` names; ``"cuda_chain"``
    runs through :class:`BatchedMatmulChain`, ``"cuda_fastmm"`` runs the
    same chain with Strassen recursion per stacked squaring (each leaf one
    K1 launch for the whole stack; held to ``fastmm.error_budget``), and
    everything else falls through to the already stack-capable
    :func:`matpow_binary`.

    ``p`` must be a python int >= 0; ``p == 0`` returns a stack of
    identities (the same contract as every other matpow entry point).
    """
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"batched_matpow needs a stacked (B, n, n) operand, "
                         f"got shape {tuple(a.shape)}")
    if not isinstance(p, int) or isinstance(p, bool):
        raise TypeError("batched_matpow requires a static python int p")
    if p < 0:
        raise ValueError("negative powers not supported")
    if backend not in _matpow._CHAIN_BACKENDS:
        return _matpow.matpow_binary(a, p, backend=backend)
    if a.shape[-1] < 1:
        raise ValueError(f"batched_matpow needs matrices with n >= 1, "
                         f"got shape {tuple(a.shape)}")
    if p == 0:
        return _matpow._eye_like(a)
    chain = BatchedMatmulChain(a.shape[0], a.shape[-1], a.dtype,
                               device=a.device,
                               fast=backend in _matpow._FAST_BACKENDS)
    return chain.unpad(_matpow._binary_chain_body(chain.pad(a), p, chain))


def batched_expm(a: torch.Tensor, *, backend: str = "torch",
                 max_squarings: int = 32) -> torch.Tensor:
    """e^{A_i} for every matrix of a stacked (B, n, n) operand.

    :func:`repro_torch.core.expm.expm` is already stack-capable (per-matrix
    scaling, stacked Pade solve, masked squarings to the stack's max s);
    this wrapper only pins the 3-D contract so the serving engine's expm
    buckets fail loudly on shape mistakes instead of silently broadcasting.
    """
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"batched_expm needs a stacked (B, n, n) operand, "
                         f"got shape {tuple(a.shape)}")
    from repro_torch.core.expm import expm
    return expm(a, backend=backend, max_squarings=max_squarings)
