"""Public wrappers around the kernels: arbitrary shapes, stacks, chains.

The port of the dense half of the reference's ``repro/kernels/ops.py``.

``matmul``      — arbitrary-shape tiled matmul: picks tiles, pads to tile
                  multiples, runs K1, strips the padding. Leading stack dims
                  are a grid axis of the same kernel (one launch).
``square``      — C = A @ A through the tiered squaring kernels, same
                  pad/dispatch contract as ``matmul``.
``MatmulChain`` — fused chain executor for repeated-multiply workloads
                  (matpow, expm): pads ONCE at entry, runs every multiply /
                  squaring on the tile-divisible padded buffer (no per-call
                  pad/unpad/tile-pick), un-pads once at exit, and squares
                  between two buffers it owns instead of allocating one per
                  step.
``attention``   — flash attention (K5) with the same device rule: the plain
                  version on a CPU tensor, the kernel on a CUDA tensor.
``pick_blocks`` — matmul tile selection: the persistent tuning cache first
                  (``repro_torch.kernels.autotune``), then a heuristic for
                  this card's shared memory and SM count.
``pick_attn_blocks``
                — the flash-attention (block_q, block_k) face of the same
                  tuning subsystem (``attention`` cache namespace).

Cache keys carry the device type of the operands (``"cuda"`` / ``"cpu"``):
the wrappers pass it; a caller without a tensor at hand (``MatmulChain``
built from a size) passes its ``device``, which defaults to ``"cuda"``.

The device rule of the package holds throughout: these functions compute
where their tensors lie. On a CUDA tensor every multiply is one of the
hand-written kernels; on a CPU tensor the same padding, tile and tier logic
runs over the plain PyTorch versions — which is what the CPU tests exercise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import dtype_name
from repro_torch.kernels import autotune
from repro_torch.kernels.attention import (HEAD_DIMS, attn_tiles,
                                           flash_attention, head_dim_for)
from repro_torch.kernels.matmul import (DMMA_BLOCKS, DMMA_TILES,
                                        F32_BLOCKS, KERNEL_TILES, SM_COUNT,
                                        SMEM_PER_BLOCK, TC_BLOCKS,
                                        TC_DEFAULT_BK, matmul_cuda,
                                        smem_footprint, square_cuda)

__all__ = ["matmul", "square", "attention", "pick_blocks", "pick_attn_blocks",
           "pad_to_blocks", "PaddedChain", "MatmulChain", "SMEM_BUDGET"]

#: Shared memory ``pick_blocks`` lets one block's staged tiles take: half of
#: a block's maximum, so at least two blocks share an SM and one computes
#: while the other waits on its loads.
SMEM_BUDGET = SMEM_PER_BLOCK // 2


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pick_blocks(m: int, n: int, k: int, dtype=None, use_cache: bool = True,
                backend=None):
    """Choose (block_m, block_n, block_k) for an (m, k) x (k, n) problem.

    Consults the tuning cache first (``autotune.lookup`` under ``backend``,
    the operands' device type, ``"cuda"`` by default); an entry is used
    only if the kernels can run it (``autotune.valid_blocks``: an
    instantiated square tile, a K step the dtype's kernel takes, a
    footprint within a block's shared memory), else it falls through to the
    heuristic, never raises.

    The heuristic is the paper's "an appropriate TILE size is used based on
    the problem and local memory available", for this card: the largest square output tile
    of ``KERNEL_TILES`` (``DMMA_TILES`` for f64, whose tensor-core K1 stops
    at 64) that still cuts the output into at least one tile per SM (a
    128-wide tile has the best FMA-to-load ratio, but sixteen of them leave
    most of the card idle), never below 64 unless the whole output fits
    one 32-wide tile; then the K step: the largest one the dtype's K1
    instantiates for the tile (``F32_BLOCKS`` for f32, ``TC_BLOCKS`` for
    bf16 / f16, ``DMMA_BLOCKS`` for f64) that is at most ``TC_DEFAULT_BK``
    and whose ring fits the shared-memory budget (``SMEM_BUDGET``); the
    smallest ring of the tile where none fits.

    Invariants (tested): block_m == block_n is one of ``KERNEL_TILES``,
    block_k divides both, ``smem_footprint`` fits the budget, and the pair
    is an instantiated one.
    """
    itemsize = torch.empty((), dtype=dtype).element_size() \
        if dtype is not None else 4
    if use_cache:
        tuned = autotune.lookup(m, n, k, dtype=dtype, backend=backend)
        if tuned is not None and autotune.valid_blocks(tuned, itemsize):
            return tuned
    tiles = DMMA_TILES if itemsize == 8 else KERNEL_TILES
    if max(m, n) <= tiles[0]:
        tile = tiles[0]
    else:
        tile = next((t for t in reversed(tiles[1:])
                     if -(-m // t) * -(-n // t) >= SM_COUNT), tiles[1])
    table = {2: TC_BLOCKS, 8: DMMA_BLOCKS}.get(itemsize, F32_BLOCKS)
    steps = [bk for t, bk in table if t == tile and bk <= TC_DEFAULT_BK]
    fits = [bk for bk in steps
            if smem_footprint((tile, tile, bk), itemsize) <= SMEM_BUDGET]
    if fits:
        return tile, tile, max(fits)
    return tile, tile, min(
        steps, key=lambda bk: smem_footprint((tile, tile, bk), itemsize))


def pick_attn_blocks(sq: int, skv: int, d: int, dtype=None,
                     use_cache: bool = True, backend=None):
    """Choose (block_q, block_k) for a flash-attention (sq, skv, d) problem.

    The attention face of the tuning subsystem: the cache's ``attention``
    namespace first, under ``backend`` (the operands' device type,
    ``"cuda"`` by default). An entry is used only if ``dtype``'s K5 (the
    tensor-core kernel for bf16 / f16, the FMA kernel else; float32 when
    None) can run it (``autotune.attn_blocks_usable``: each block, clamped
    to its length, divides it, and an instantiated tile within a block's
    shared memory holds the pair); an invalid entry falls through to the
    heuristic, never raises.

    The heuristic starts from the widest instantiated tile (128) clamped to
    the length; a ragged length takes its largest divisor up to 128 (333 ->
    111), and a length whose only such divisors are below 16 takes the whole
    axis as one block. While no instantiated tile holds the pair, a block
    steps down to the next smaller divisor of its length (at least 16): the
    query block if no tile is tall enough for it, else the key block.
    ``ValueError`` when no tiling can exist (a prime length above 128, a
    head dim above the widest instantiated one): pad the sequence.
    """
    if use_cache:
        tuned = autotune.lookup(sq, skv, d, dtype=dtype, backend=backend,
                                kernel="attention")
        if tuned is not None and autotune.attn_blocks_usable(sq, skv, d,
                                                             tuned, dtype):
            return tuned
    table = attn_tiles(dtype)
    widest = max(t for tiles in table.values() for pair in tiles
                 for t in pair)

    def seq_block(s):
        b = min(widest, s)
        if s % b == 0:
            return b
        b = max(x for x in range(1, b + 1) if s % x == 0)
        return s if b < 16 < s else b

    def smaller(s, b):
        return next((x for x in range(b - 1, 15, -1) if s % x == 0), None)

    def usable(bq, bk):
        return autotune.attn_blocks_usable(sq, skv, d, (bq, bk), dtype)

    bq, bk = seq_block(sq), seq_block(skv)
    tiles = table[head_dim_for(d)] if d <= max(HEAD_DIMS) else ()
    tallest = max((t[0] for t in tiles), default=0)
    while not usable(bq, bk):
        if (bq > tallest or smaller(skv, bk) is None) \
                and smaller(sq, bq) is not None:
            bq = smaller(sq, bq)
        elif smaller(skv, bk) is not None:
            bk = smaller(skv, bk)
        else:
            break
    if not usable(bq, bk):
        raise ValueError(
            f"no usable attention tiling for seq lens ({sq},{skv}) at d={d}: "
            f"no block that divides them fits an instantiated tile "
            f"(head dims {list(HEAD_DIMS)}, tiles {table}); pad the "
            f"sequence to a multiple of 32")
    return bq, bk


def _square_blocks(n: int, dtype, blocks=None, backend=None):
    """(blocks, padded_n) for an (n, n) squaring-chain problem.

    The padded size must divide by all three block dims (the output of one
    multiply feeds the next, so M = N = K): it is ``n`` rounded up to their
    lcm. The heuristic's tiles are powers of two, so the lcm is the output
    tile and n = 1000 pads to 1024. A tiling from the CACHE whose lcm would
    blow the padding up (e.g. a K step of 24 beside a 32 tile -> lcm 96 for
    n = 20) falls back to the uncached heuristic. Explicitly supplied
    ``blocks`` are always honoured.
    """
    if blocks is not None:
        bm, bn, bk = blocks
        return (bm, bn, bk), _round_up(n, math.lcm(bm, bn, bk))
    bm, bn, bk = pick_blocks(n, n, n, dtype=dtype, backend=backend)
    step = math.lcm(bm, bn, bk)
    if step > 2 * _round_up(n, KERNEL_TILES[0]):
        bm, bn, bk = pick_blocks(n, n, n, dtype=dtype, use_cache=False)
        step = math.lcm(bm, bn, bk)
    return (bm, bn, bk), _round_up(n, step)


def pad_to_blocks(a: torch.Tensor, block_m: int, block_n: int) -> torch.Tensor:
    """Zero-pad the trailing two dims of ``a`` up to block multiples.

    No-op (returns ``a`` itself) when already divisible; otherwise a new
    tensor. The chain executor calls this exactly once per chain; ``matmul``
    once per operand.
    """
    m, n = a.shape[-2], a.shape[-1]
    mp, np_ = _round_up(m, block_m), _round_up(n, block_n)
    if (mp, np_) == (m, n):
        return a
    return F.pad(a, (0, np_ - n, 0, mp - m))


def _as_stack(x: torch.Tensor):
    """View (..., r, c) as 2-D or (B, r, c); returns (view, leading dims)."""
    if x.ndim <= 3:
        return x, None
    return x.reshape(-1, *x.shape[-2:]), x.shape[:-2]


def matmul(a: torch.Tensor, b: torch.Tensor, *, blocks=None,
           out_dtype=None) -> torch.Tensor:
    """C = A @ B via the tiled kernel; arbitrary shapes and stacking.

    a: (..., M, K), b: (..., K, N); leading dims must match exactly or be
    absent on one side (a 2-D operand is shared by the whole stack). The
    stack is one launch: a grid axis of the kernel, not a loop.
    """
    if a.ndim < 2 or b.ndim < 2:
        raise ValueError(f"unsupported batch ranks {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.ndim > 2 and b.ndim > 2 and a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"unsupported batch ranks {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    bm, bn, bk = blocks or pick_blocks(m, n, k, dtype=a.dtype,
                                       backend=a.device.type)

    a_s, lead_a = _as_stack(pad_to_blocks(a, bm, bk).contiguous())
    b_s, lead_b = _as_stack(pad_to_blocks(b, bk, bn).contiguous())
    out = matmul_cuda(a_s, b_s, block_m=bm, block_n=bn, block_k=bk,
                      out_dtype=out_dtype or a.dtype)
    if out.shape[-2:] != (m, n):
        out = out[..., :m, :n]
    lead = lead_a if lead_a is not None else lead_b
    if lead is not None:
        out = out.reshape(*lead, m, n)
    return out


def square(a: torch.Tensor, *, blocks=None, out_dtype=None) -> torch.Tensor:
    """C = A @ A via the tiered squaring kernels; arbitrary square shapes,
    2-D or stacked. Kernel choice (whole-operand / panel / two-operand)
    follows the ``square_tier`` policy with limits from the tuning cache
    (``autotune.square_tiers``), resolved once per call."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"square needs square matrices, got "
                         f"{tuple(a.shape)}")
    n = a.shape[-1]
    backend = a.device.type
    (bm, bn, bk), padded_n = _square_blocks(n, a.dtype, blocks, backend)
    smem_limit, panel_limit = autotune.square_tiers(a.dtype, backend)
    padded, lead = _as_stack(pad_to_blocks(a, padded_n, padded_n).contiguous())
    out = square_cuda(padded, block_m=bm, block_n=bn, block_k=bk,
                      out_dtype=out_dtype or a.dtype, smem_limit=smem_limit,
                      panel_limit=panel_limit)
    if padded_n != n:
        out = out[..., :n, :n]
    if lead is not None:
        out = out.reshape(*lead, n, n)
    return out


class PaddedChain:
    """Pad-once / unpad-once plumbing shared by the chain executors.

    A chain of k same-shape square multiplies needs exactly ONE pad at entry
    and ONE un-pad at exit — zero-padding is closed under multiplication
    ([[A,0],[0,0]]^2 = [[A^2,0],[0,0]]):

        x = chain.pad(a)            # once: (..., n, n) -> (..., P, P)
        x = chain.square(x)         # k times on the padded buffer
        out = chain.unpad(result)   # once: strip back to (..., n, n)

    Subclasses set ``self.padded_n`` (the chain-invariant padded size P) in
    their ``__init__`` and implement ``square``/``mm``. ``donate`` records
    whether squarings consume their operand's buffer; ``pad`` honours it by
    never handing the caller's own tensor into the chain.
    """

    def __init__(self, n: int, dtype, *, donate: bool = True):
        self.n = int(n)
        if self.n < 1:
            # A 0-size chain would "work" — every pad/square/unpad is an
            # empty-tensor no-op — and hand back identity-shaped garbage.
            raise ValueError(f"chain matrices must have n >= 1, got n={n!r}")
        dtype_name(dtype)  # raises TypeError on an unsupported dtype
        self.dtype = dtype
        self.donate = bool(donate)
        self.padded_n = self.n

    # -- chain boundary ----------------------------------------------------
    def pad(self, a: torch.Tensor) -> torch.Tensor:
        """Zero-pad (..., n, n) -> (..., P, P), contiguous. Called once per
        chain.

        When padding is a no-op and donation is on, the caller gets a copy
        instead of its own tensor back: ``square`` reuses its operand's
        buffer two steps later, and the chain must never write into the
        caller's tensor.
        """
        if self.padded_n != self.n:
            return pad_to_blocks(a, self.padded_n, self.padded_n)
        if self.donate:
            return a.clone(memory_format=torch.contiguous_format)
        return a.contiguous()

    def unpad(self, c: torch.Tensor) -> torch.Tensor:
        """Strip back to (..., n, n). Called once per chain."""
        if self.padded_n == self.n:
            return c
        return c[..., : self.n, : self.n]


class MatmulChain(PaddedChain):
    """Fused executor for a chain of same-shape square multiplies.

    Hoists everything ``ops.matmul`` pays per call — tile pick, padding of
    both operands, stripping — to the chain boundary (see
    :class:`PaddedChain`):

        chain = MatmulChain(a.shape[-1], a.dtype)
        x = chain.pad(a)            # once
        x = chain.square(x)         # k times, tile-divisible fast path
        ...
        out = chain.unpad(result)   # once

    Tiles and the squaring-tier limits are fixed once per chain (the tuning
    cache's entries for ``device``'s type, or the heuristic and the
    defaults), so every squaring of a chain runs the same kernel.

    Donation. The reference donates the squaring operand's buffer to the
    result; the PyTorch form is a chain that owns two padded buffers and
    ping-pongs between them: ``square(x)`` writes into the chain's spare
    buffer (``out=``, never ``x`` itself — the kernels read whole panels of
    ``x`` while writing) and keeps ``x``'s buffer as the next spare. So with
    ``donate=True`` treat the argument of ``square`` as CONSUMED: it is
    overwritten by the squaring after next. Clone first if you hold another
    reference (``core.matpow._binary_chain_body`` does). ``donate=False``
    allocates a fresh result per squaring and never touches its operand.

    Works on ``(..., P, P)`` stacks as well: the stack is a grid axis of the
    kernels, one launch per multiply for all of it.
    """

    def __init__(self, n: int, dtype, *, blocks=None, donate: bool = True,
                 device=None):
        super().__init__(n, dtype, donate=donate)
        backend = None if device is None else torch.device(device).type
        self.blocks, self.padded_n = _square_blocks(self.n, self.dtype, blocks,
                                                    backend)
        # Squaring-tier limits fixed once per chain, so every squaring of a
        # chain uses the same kernel tier.
        self.tiers = autotune.square_tiers(self.dtype, backend)
        self._spare = None

    # -- chain body (operands already padded) ------------------------------
    def mm(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x @ y on padded buffers — no pad/unpad, tiles fixed per chain.
        Always a fresh result; neither operand is written."""
        bm, bn, bk = self.blocks
        xs, lead = _as_stack(x)
        ys, _ = _as_stack(y)
        out = matmul_cuda(xs, ys, block_m=bm, block_n=bn, block_k=bk,
                          out_dtype=self.dtype)
        return out if lead is None else out.reshape(x.shape)

    def square(self, x: torch.Tensor) -> torch.Tensor:
        """x @ x via the tiered squaring kernels; CONSUMES x when the chain
        donates (see the class docstring)."""
        bm, bn, bk = self.blocks
        smem_limit, panel_limit = self.tiers
        xs, lead = _as_stack(x)
        out = None
        if self.donate:
            spare, self._spare = self._spare, xs
            if spare is not None and spare.shape == xs.shape \
                    and spare.dtype == self.dtype \
                    and spare.device == xs.device \
                    and spare.data_ptr() != xs.data_ptr():
                out = spare
        res = square_cuda(xs, block_m=bm, block_n=bn, block_k=bk,
                          out_dtype=self.dtype, smem_limit=smem_limit,
                          panel_limit=panel_limit, out=out)
        return res if lead is None else res.reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, scale=None, block_q=None,
              block_k=None) -> torch.Tensor:
    """Flash attention, q: (..., Sq, D), k/v: (..., Skv, D).

    A CPU tensor runs the plain version, a CUDA tensor K5
    (``attention.flash_attention``). ``block_q`` / ``block_k`` default to
    ``None``, resolved through ``pick_attn_blocks`` (cache entry first,
    heuristic on a miss); explicit ints are honoured and must divide the
    sequence lengths after clamping (``ValueError`` otherwise).
    """
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                           block_q=block_q, block_k=block_k)
