"""Operands made on the device from the seed, in a few large calls.

``power_operands`` is ``chip_smoke.power_operand`` (``tools/sharded_mesh.py``
``operand`` is the same matrix) made with a ``torch.Generator`` on the card
instead of numpy on the host: ``(1 - eps) P + eps S``, P the permutation
matrix of one random n-cycle, S dense random row-stochastic. Every power is
row-stochastic, so A^p neither overflows nor vanishes, and row i of A^p
peaks about (1 - eps)^p where P^p sends i, so a wrong exponent shows.

``ncd_operands`` are nearly completely decomposable chains (Courtois 1977;
Stewart 1994, ch. 6): ``blocks`` dense diagonal blocks, each row keeping
mass 1 - eps inside its block and spreading eps over the other blocks, so
the second eigenvalue is about 1 - eps and the squaring loop needs about
log2(14 / eps) + 1 squarings to reach a residual of 1e-6.
"""

from __future__ import annotations

import torch

__all__ = ["generator", "power_operands", "ncd_operands", "ncd_eps"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer: taken
    modulo 2**64); the same seed gives the same numbers on every card."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def power_operands(count: int, n: int, dtype, device, gen,
                   eps: float) -> torch.Tensor:
    """(count, n, n) operands ``(1 - eps) P + eps S`` in ``dtype``."""
    s = torch.rand((count, n, n), generator=gen, device=device,
                   dtype=torch.float32).add_(0.05)
    s.mul_(eps / s.sum(dim=-1, keepdim=True))
    for m in s:
        cycle = torch.randperm(n, generator=gen, device=device)
        m[cycle, cycle.roll(-1)] += 1.0 - eps
    return s.to(dtype)


def ncd_eps(count: int, lo: float, hi: float) -> list:
    """The coupling eps of each of ``count`` chains: the count-quantiles of
    the log-uniform distribution on [lo, hi], the same for every seed."""
    return [lo * (hi / lo) ** ((i + 0.5) / count) for i in range(count)]


def ncd_operands(count: int, n: int, blocks: int, eps, dtype, device,
                 gen) -> torch.Tensor:
    """(count, n, n) NCD transition matrices in ``dtype``; chain i couples
    its blocks with ``eps[i]``."""
    if n % blocks:
        raise ValueError(f"n = {n} is not a multiple of {blocks} blocks")
    r = torch.rand((count, n, n), generator=gen, device=device,
                   dtype=torch.float64).add_(0.05)
    block = torch.arange(n, device=device) // (n // blocks)
    inside = (block[:, None] == block[None, :]).to(torch.float64)
    e = torch.tensor(eps, dtype=torch.float64, device=device)[:, None, None]
    within = r * inside
    within.mul_((1.0 - e) / within.sum(dim=-1, keepdim=True))
    r.mul_(1.0 - inside)
    r.mul_(e / r.sum(dim=-1, keepdim=True))
    return r.add_(within).to(dtype)
