"""Stochastic (Markov-chain) workloads on the squaring chain.

The port of the reference's ``repro/core/markov.py``. The paper motivates
A^n with "financial, statistical applications"; the canonical one is the
Markov chain, and its two query shapes are not plain fixed-power matpow:

  * ``steady_state`` — the horizon is unknown: square until the chain
    stops moving. A host loop squares on the chain and reads the
    between-squaring residual ``max_i sum_j |P^{2^k} - P^{2^{k-1}}|`` (the
    induced infinity norm) once per squaring — one device-to-host
    synchronisation each — and stops a well-mixed chain after a handful of
    squarings where a fixed p = 2^20 policy pays 20. Each iteration is
    exactly one squaring of :class:`repro_torch.kernels.ops.MatmulChain`'s
    padded buffer, so at equal squaring counts the result has the bits of
    ``matpow_binary(p, 2**k, backend=...)``.
  * ``evolve_distributions`` — B start distributions share ONE transition
    matrix over a known horizon. Evolving the (B, n) stack by the binary
    decomposition of the horizon replaces every O(n^3) combine of the
    matpow route with an O(B n^2) vector–matrix product
    (``ops.dense_matmul``: K1 on the card); above a tuned B/n ratio it falls
    back to the dense route.

``validate_stochastic`` is the host-side admission gate for both (row sums,
non-negativity, optional renormalisation). float32 or float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import matpow

__all__ = [
    "validate_stochastic",
    "markov_power",
    "steady_state",
    "evolve_distributions",
    "SteadyStateResult",
]


def validate_stochastic(p: torch.Tensor, *, tol: float = 1e-5,
                        renormalize: bool = False) -> torch.Tensor:
    """Check (or repair) a row-stochastic transition matrix, on the host.

    Accepts (..., n, n) stacks. Entries must be >= -tol and every row must
    sum to 1 within ``tol``; violations raise ``ValueError``. With
    ``renormalize=True`` the row-sum check becomes a repair: tiny negatives
    (within tol) are clipped to zero and each row is divided by its sum —
    a row whose sum is not strictly positive still raises.

    Reading the minimum and the row sums of a CUDA tensor is a
    device-to-host synchronisation: this is a gate for entry points. The
    serving engine leaves it to the caller (a synchronisation per submit
    would stall the daemon), so gate inputs here before
    ``submit("markov", ...)``.
    """
    if p.ndim < 2 or p.shape[-1] != p.shape[-2] or p.shape[-1] < 1:
        raise ValueError(f"transition matrices must be square with n >= 1, "
                         f"got shape {tuple(p.shape)}")
    min_entry = float(p.min())
    if min_entry < -tol:
        raise ValueError(f"stochastic matrix entries must be non-negative, "
                         f"found {min_entry:.3g} (< -tol = {-tol:g})")
    if renormalize:
        clipped = p.clamp(min=0.0)
        rows = clipped.sum(dim=-1, keepdim=True)
        min_row = float(rows.min())
        if min_row <= 0.0:
            raise ValueError(f"cannot renormalize: a row sums to "
                             f"{min_row:.3g} (must be > 0)")
        return (clipped / rows).to(p.dtype)
    row_err = float((p.sum(dim=-1) - 1.0).abs().max())
    if row_err > tol:
        raise ValueError(f"rows must sum to 1: max |row_sum - 1| = "
                         f"{row_err:.3g} > tol = {tol:g} (pass "
                         f"renormalize=True to repair)")
    return p


def markov_power(p: torch.Tensor, steps: int, *, backend: str = "torch",
                 validate: bool = True, validate_tol: float = 1e-5,
                 renormalize: bool = False) -> torch.Tensor:
    """P^steps for a validated transition matrix — fixed-horizon queries:
    ``validate_stochastic``, then :func:`repro_torch.core.matpow.
    matpow_binary` on ``backend``. For unknown horizons use
    :func:`steady_state`; for batches of start distributions
    :func:`evolve_distributions`."""
    if validate:
        p = validate_stochastic(p, tol=validate_tol, renormalize=renormalize)
    return matpow.matpow_binary(p, steps, backend=backend)


class SteadyStateResult(NamedTuple):
    """:func:`steady_state`'s outputs.

    ``pi``         (n,) stationary distribution (row mean of ``matrix``,
                   renormalised to sum to 1 in its dtype).
    ``matrix``     (n, n) ``P^(2^squarings)`` — every row ~= ``pi`` at
                   convergence; the bits of ``matpow_binary(p,
                   2**squarings)`` on the same backend.
    ``squarings``  0-d int32 tensor on ``p``'s device — squarings paid.
    ``residual``   0-d tensor (float32, float64 for float64 input) on
                   ``p``'s device: the infinity norm of the last
                   between-squaring delta — at or below ``tol`` iff the
                   loop stopped by convergence rather than by the
                   ``max_squarings`` cap.
    """

    pi: torch.Tensor
    matrix: torch.Tensor
    squarings: torch.Tensor
    residual: torch.Tensor


def steady_state(p: torch.Tensor, *, tol: float = 1e-6,
                 max_squarings: int = 20, backend: str = "torch",
                 validate: bool = True, validate_tol: float = 1e-5,
                 renormalize: bool = False,
                 chain=None) -> SteadyStateResult:
    """Stationary distribution by convergence-aware repeated squaring.

    Squares P until the between-squaring residual
    ``‖P^{2^k} − P^{2^{k-1}}‖∞`` (largest row sum of absolute deltas) drops
    to ``tol`` or ``max_squarings`` is reached. The residual is read on the
    host after every squaring (one synchronisation each; the reference's
    ``lax.while_loop`` reads its condition on the device). The squarings run
    on ``chain_for(p, backend, donate=False)``, the pad-once buffer
    :func:`repro_torch.core.matpow.matpow_binary` uses; padded rows are zero
    in both buffers, so they add 0 to the residual, which is computed on the
    padded buffer in float32 (float64 for float64 input). The matrix is
    unpadded before its rows are averaged.

    ``chain`` replaces the backend's chain with a caller-built executor of
    the same pad / square / unpad contract (build it with
    ``donate=False``). One (n, n) matrix only — the engine maps its buckets
    per member, so each member keeps its own squaring count.
    """
    if p.ndim != 2 or p.shape[-1] != p.shape[-2] or p.shape[-1] < 1:
        raise ValueError(f"steady_state takes one (n, n) matrix with "
                         f"n >= 1, got shape {tuple(p.shape)}; batches are "
                         f"served per member (see serve.matfn op='markov')")
    if max_squarings < 1:
        raise ValueError(f"max_squarings must be >= 1, got {max_squarings}")
    if validate:
        p = validate_stochastic(p, tol=validate_tol, renormalize=renormalize)

    if chain is None:
        chain = matpow.chain_for(p, backend, donate=False)
    if chain is not None:
        square = chain.square
        x = chain.pad(p)
    else:
        mm = matpow.matmul_backend(backend)
        square = lambda t: mm(t, t)
        x = p

    rdtype = torch.float64 if p.dtype == torch.float64 else torch.float32
    k = 0
    resid = None
    # ``resid > tol`` compares in rdtype, as the reference's loop condition
    # does; bool() is the one synchronisation per squaring.
    while k < max_squarings and (resid is None or bool(resid > tol)):
        nxt = square(x)
        resid = (nxt - x).to(rdtype).abs().sum(dim=-1).max()
        x = nxt
        k += 1

    m = chain.unpad(x) if chain is not None else x
    pi = m.mean(dim=0)
    pi = pi / pi.sum()
    return SteadyStateResult(
        pi=pi, matrix=m,
        squarings=torch.tensor(k, dtype=torch.int32, device=p.device),
        residual=resid)


def evolve_distributions(dists: torch.Tensor, p: torch.Tensor, steps: int, *,
                         backend: str = "torch", validate: bool = True,
                         validate_tol: float = 1e-5,
                         renormalize: bool = False,
                         dense_threshold: Optional[float] = None
                         ) -> torch.Tensor:
    """Evolve B start distributions ``steps`` transitions under one P.

    The binary decomposition of the horizon applied to the (B, n) stack,
    LSB first: each set bit costs one (B, n) x (n, n) vector–matrix product
    (``ops.dense_matmul``: K1 on a CUDA tensor), each remaining bit one
    squaring of P on the chain (``bit_length(steps) - 1`` of them). Against
    ``matpow_binary`` and one apply, the ``popcount - 1`` O(n^3) combines
    become O(B n^2) products.

    When B exceeds ``dense_threshold * n`` the extra products outweigh the
    saved combines and the dense route (one ``markov_power``, one apply)
    runs instead. ``dense_threshold=None`` reads the tuning cache's
    ``markov`` namespace (``autotune.markov_evolve_threshold``, default 1.0:
    evolve while B <= n).

    ``dists`` is (n,) or (B, n); its rows need no validation (any
    non-negative weights evolve linearly), only ``p`` is gated. ``steps``
    must be a Python int >= 0. On the chain, ``dists`` is padded to the
    chain's ``padded_n`` columns and the columns are stripped after the
    loop. Returns the evolved stack in the promoted dtype of ``dists`` and
    ``p``.
    """
    if not isinstance(steps, int) or isinstance(steps, bool):
        raise TypeError(f"steps must be a static python int, "
                        f"got {type(steps).__name__}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    d = dists
    single = d.ndim == 1
    if single:
        d = d[None, :]
    if d.ndim != 2:
        raise ValueError(f"dists must be (n,) or (B, n), got shape "
                         f"{tuple(dists.shape)}")
    if p.ndim != 2 or p.shape[-1] != p.shape[-2] or p.shape[-1] < 1:
        raise ValueError(f"transition matrix must be (n, n) with n >= 1, "
                         f"got shape {tuple(p.shape)}")
    n = p.shape[-1]
    if d.shape[-1] != n:
        raise ValueError(f"dists feature dim {d.shape[-1]} != matrix "
                         f"n = {n}")
    if validate:
        p = validate_stochastic(p, tol=validate_tol, renormalize=renormalize)

    dtype = torch.promote_types(d.dtype, p.dtype)
    d = d.to(dtype)
    p = p.to(dtype)
    if steps == 0:
        return (d[0] if single else d).clone()

    from repro_torch.kernels import ops as kops

    b = d.shape[0]
    if dense_threshold is None:
        from repro_torch.kernels import autotune
        dense_threshold = autotune.markov_evolve_threshold(
            dtype, backend=p.device.type)
    if b > dense_threshold * n:
        # Many distributions: the combines are cheaper than B-row products —
        # the plain matpow route, then one apply.
        m = markov_power(p, steps, backend=backend, validate=False)
        out = kops.dense_matmul(d, m)
        return (out[0] if single else out).to(dtype)

    # Host loop over the bits of ``steps``. A donating chain's squaring
    # writes the buffer of two squarings ago, which every product that read
    # it precedes on the stream.
    chain = matpow.chain_for(p, backend)
    if chain is not None:
        base = chain.pad(p)
        pn = chain.padded_n
        if pn != n:
            d = F.pad(d, (0, pn - n))
        square = chain.square
    else:
        base = p
        pn = n
        mm = matpow.matmul_backend(backend)
        square = lambda t: mm(t, t)

    acc = d
    t = steps
    while True:
        if t & 1:
            # Row-vector step: d' = d @ P^(2^bit), through K1.
            acc = kops.dense_matmul(acc, base)
        t >>= 1
        if t == 0:
            break
        base = square(base)

    if pn != n:
        acc = acc[:, :n]
    out = acc[0] if single else acc
    return out.to(dtype)
