"""The plain reference the benchmark holds the port's answers to.

Plain PyTorch (``torch.matmul``, no kernel of the port): it imports
nothing of ``repro_torch``, ``repro`` or ``jax``, and takes only the
operands the benchmark made, never anything the program derived from them.
It runs in float64 with TF32 off; :func:`matpow` and :func:`steady_state`
take a ``precision`` so that the control (the same reference one precision
below the configuration's) runs the same code.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

__all__ = ["matpow", "steady_state", "SteadyState", "precision"]


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for float32 products (off for the reference, on for
    the float32 configurations' control), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def matpow(a: torch.Tensor, p: int, *, dtype=torch.float64,
           tf32: bool = False) -> torch.Tensor:
    """A^p by binary exponentiation in ``dtype`` (float64 by default)."""
    if p < 0:
        raise ValueError("negative powers are not served")
    x = a.to(dtype)
    out = None
    with precision(tf32):
        while True:
            if p & 1:
                out = x if out is None else out @ x
            p >>= 1
            if not p:
                break
            x = x @ x
    if out is None:
        return torch.eye(a.shape[-1], dtype=dtype, device=a.device)
    return out


class SteadyState(NamedTuple):
    pi: torch.Tensor          # (n,) stationary distribution
    squarings: int            # squarings paid
    residual: float           # the last between-squaring residual


def steady_state(p: torch.Tensor, *, tol: float, max_squarings: int,
                 dtype=torch.float64, tf32: bool = False) -> SteadyState:
    """Stationary distribution by squaring until the infinity norm of the
    between-squaring change ``max_i sum_j |P^(2^k) - P^(2^(k-1))|`` is at
    most ``tol`` or ``max_squarings`` squarings are paid; ``pi`` is the mean
    of the rows of the last power, divided by its sum."""
    x = p.to(dtype)
    k, resid = 0, None
    with precision(tf32):
        while k < max_squarings and (resid is None or resid > tol):
            nxt = x @ x
            resid = float((nxt - x).abs().sum(dim=-1).max())
            x = nxt
            k += 1
    pi = x.mean(dim=0)
    return SteadyState(pi / pi.sum(), k, resid)
