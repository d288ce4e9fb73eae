"""Matrix exponentiation A^n — the paper's core contribution, on the GPU.

The port of the reference's ``repro/core/matpow.py``:

  * ``matpow_naive``   — the paper's "Naive GPU" baseline: n-1 sequential full
    matrix multiplications, one kernel launch per multiply.
  * ``matpow_binary``  — the paper's "Our Approach": exponentiation by
    squaring, floor(log2 n) squarings + popcount(n)-1 combines.
  * ``matpow_binary_traced`` — the same algorithm for a power that arrives
    as a 0-d integer tensor (or a plain int).

Backends (``matmul_backend``):

  * ``"torch"``      — ``torch.matmul`` with full-precision accumulation
    (stands where the reference has ``"xla"``).
  * ``"cuda"``       — every multiply through ``kernels.ops.matmul``: pick
    tiles, pad, the hand-written kernel, strip (the reference's
    ``"pallas"``).
  * ``"cuda_chain"`` — the whole squaring/combine chain fused through
    ``kernels.ops.MatmulChain``: the operand is padded to tile multiples
    ONCE at entry, every multiply runs tile-divisible on the padded buffer
    (squarings through the tiered squaring kernels, ping-ponging between two
    buffers the chain owns), and the result is un-padded once at exit (the
    reference's ``"pallas_chain"``).

There is no interpret-mode twin: the same backend name computes where the
operand lies. On a CUDA tensor ``"cuda"`` / ``"cuda_chain"`` launch the
kernels; on a CPU tensor they run the same padding, tier and chain logic over
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import exact_matmul_settings

__all__ = [
    "matpow_naive",
    "matpow_binary",
    "matpow_binary_traced",
    "matmul_backend",
    "chain_for",
]

#: Backends that take the fused chain-execution route.
_CHAIN_BACKENDS = frozenset({"cuda_chain"})


def matmul_backend(backend: str = "torch", precision=None) -> Callable:
    """Return a (a, b) -> a @ b callable for the requested backend.

    backend:
      * ``"torch"``      — ``torch.matmul`` in the working dtype, with TF32
        and the reduced-precision 16-bit reductions switched off
        (``repro_torch.exact_matmul_settings``), i.e. fp32 accumulation for
        f32/bf16/f16 and f64 for f64.
      * ``"cuda"``       — the tiled kernel per call
        (``repro_torch.kernels.ops.matmul``).
      * ``"cuda_chain"`` — the fused chain route. The matpow/expm entry
        points recognise it and hoist padding to the chain boundary via
        :func:`chain_for`; as a bare (a, b) callable it behaves like
        ``"cuda"``.

    Any other name — the Strassen (``fastmm``) routes included, until they
    are ported — raises ``ValueError``.

    precision: the reference's ``precision`` argument. Every route computes
    exact products with fp32 (f64) accumulation and no TF32, which is the
    reference's ``None`` / ``"highest"`` (``"float32"`` is JAX's synonym
    for it); those are accepted on every route, in any case, and any other
    value raises ``ValueError`` naming the route rather than computing
    something other than what was asked.
    """
    if backend == "torch":
        route = torch.matmul
    elif backend == "cuda" or backend in _CHAIN_BACKENDS:
        from repro_torch.kernels import ops as kops
        route = kops.matmul
    else:
        raise ValueError(f"unknown matmul backend: {backend!r}")
    if precision is not None \
            and str(precision).lower() not in ("highest", "float32"):
        raise ValueError(
            f"matmul backend {backend!r} computes at precision 'highest' "
            f"(exact fp32 / f64 accumulation, no TF32) only, got precision="
            f"{precision!r}")
    if backend == "torch":
        exact_matmul_settings()
    return route


def chain_for(a: torch.Tensor, backend: str, donate: bool = True):
    """A ``MatmulChain`` for ``a``'s shape when ``backend`` requests the
    fused route, else None (callers fall back to the per-multiply path).

    Pass ``donate=False`` when the caller needs a squaring's operand after
    the squaring (``expm``'s masked loop does): a donating chain reuses the
    operand's buffer two squarings later.
    """
    if backend not in _CHAIN_BACKENDS:
        matmul_backend(backend)  # raises on an unknown name
        return None
    from repro_torch.kernels import ops as kops
    return kops.MatmulChain(a.shape[-1], a.dtype, donate=donate,
                            device=a.device)


def _check_square(a: torch.Tensor) -> int:
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"matpow needs square matrices, got shape "
                         f"{tuple(a.shape)}")
    if a.shape[-1] < 1:
        # Every op on a 0-size matrix is an empty-tensor no-op, so the chain
        # would silently return identity-shaped garbage; fail loudly instead.
        raise ValueError(f"matpow needs matrices with n >= 1, got shape "
                         f"{tuple(a.shape)}")
    return a.shape[-1]


def _eye_like(a: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return eye.expand(a.shape).contiguous()


def matpow_naive(a: torch.Tensor, n: int, *, backend: str = "torch") -> torch.Tensor:
    """A^n with n-1 sequential multiplies — the paper's Naive GPU baseline.

    Kept deliberately dumb (a loop of full matmuls) so benchmarks compare
    the paper's two algorithms on equal kernel footing. ``n`` must be a
    Python int >= 0. Supports stacks (..., m, m). ``a`` is never written.
    """
    if not isinstance(n, int) or isinstance(n, bool):
        raise TypeError("matpow_naive requires a static python int n")
    if n < 0:
        raise ValueError("negative powers not supported (matrix may be singular)")
    _check_square(a)
    if n == 0:
        return _eye_like(a)
    chain = chain_for(a, backend, donate=False)  # mm never writes an operand
    if chain is not None:
        ap = chain.pad(a)
        out = ap
        for _ in range(n - 1):
            out = chain.mm(out, ap)
        out = chain.unpad(out)
        return out.clone() if out is a else out
    mm = matmul_backend(backend)
    out = a
    for _ in range(n - 1):
        out = mm(out, a)
    return out.clone() if out is a else out


def matpow_binary(a: torch.Tensor, n: int, *, backend: str = "torch") -> torch.Tensor:
    """A^n by exponentiation-by-squaring — the paper's "Our Approach".

    Exactly ``bit_length(n)-1`` squarings plus ``popcount(n)-1`` combines,
    each one kernel launch on the kernel backends (the launch counters of
    ``repro_torch.kernels.matmul`` show it). Supports stacks (..., m, m).
    ``a`` is never written; the result is a new tensor.
    """
    if not isinstance(n, int) or isinstance(n, bool):
        raise TypeError("matpow_binary requires a static python int n; "
                        "use matpow_binary_traced for a tensor n")
    if n < 0:
        raise ValueError("negative powers not supported")
    _check_square(a)
    if n == 0:
        return _eye_like(a)
    chain = chain_for(a, backend)
    if chain is not None:
        # chain.pad guarantees the returned buffer is the chain's own (copy
        # on identity-pad), so squarings never write the caller's tensor.
        return chain.unpad(_binary_chain_body(chain.pad(a), n, chain))
    mm = matmul_backend(backend)
    result = None
    base = a
    while True:
        if n & 1:
            result = base if result is None else mm(result, base)
        n >>= 1
        if n == 0:
            break
        base = mm(base, base)
    return result.clone() if result is a else result


def _binary_chain_body(base: torch.Tensor, n: int, chain) -> torch.Tensor:
    """Squaring/combine loop on the padded buffer. ``chain.square`` consumes
    its input (the buffer is reused two squarings later), so when ``result``
    first aliases ``base`` (and squarings remain) it takes a cheap O(n^2)
    copy instead of sharing the buffer. The result is seeded from the first
    set bit — no identity multiply."""
    result = None
    while True:
        if n & 1:
            if result is None:
                result = base if n == 1 else base.clone()
            else:
                result = chain.mm(result, base)
        n >>= 1
        if n == 0:
            return result
        base = chain.square(base)


def _read_power(n) -> int:
    """``n`` as a Python int: an int, a numpy integer, or a 0-d integer
    tensor (read with one device-to-host synchronisation)."""
    if isinstance(n, bool):
        raise TypeError("matpow_binary_traced needs an integer power")
    if isinstance(n, (int, np.integer)):
        return int(n)
    if isinstance(n, torch.Tensor):
        if n.ndim != 0 or n.dtype.is_floating_point or n.dtype.is_complex \
                or n.dtype == torch.bool:
            raise TypeError(f"matpow_binary_traced needs a 0-d integer "
                            f"tensor, got shape {tuple(n.shape)} dtype "
                            f"{n.dtype}")
        return int(n)
    if isinstance(n, np.ndarray) and n.ndim == 0 \
            and np.issubdtype(n.dtype, np.integer):
        return int(n)
    raise TypeError(f"matpow_binary_traced needs an integer power, got "
                    f"{type(n).__name__}")


def matpow_binary_traced(a: torch.Tensor, n, *, backend: str = "torch",
                         max_bits: int = 32) -> torch.Tensor:
    """A^n for a power that is data: a 0-d integer tensor (or an int).

    The reference compiles one program for every power with
    ``lax.while_loop``; PyTorch runs eagerly and has no trace, so the power
    is read ONCE with ``int(n)`` — one device-to-host synchronisation when
    ``n`` lives on the GPU — and the same squaring/combine loop as
    :func:`matpow_binary` runs on the host: seeded from the first set bit,
    exactly bit_length(n)-1 squarings + popcount(n)-1 combines.

    A negative ``n`` is clamped to 0 and gives the identity (the static
    siblings raise; data cannot). ``max_bits`` bounds the loop: a power that
    needs more bits raises ``ValueError``.
    """
    _check_square(a)
    power = max(_read_power(n), 0)
    if power.bit_length() > max_bits:
        raise ValueError(f"power {power} needs more than max_bits="
                         f"{max_bits} bits")
    return matpow_binary(a, power, backend=backend)
