"""Flash attention (K5): the wrapper, its plain version, the tile table and
the launch counter.

The port of the reference's ``repro/kernels/attention.py``. One hand-written
CUDA kernel (``csrc/attention.cuh``) stands where its Pallas kernel
``_attn_kernel`` stood: online-softmax attention over KV tiles, causal and
sliding-window masks, queries right-aligned against the keys, so the
Sq x Skv score matrix never exists in device memory. The leading dims of
``q`` (batch, heads) are one grid axis of one launch — the reference's
``jax.vmap`` over one-slice calls.

Blocks and tiles. ``block_q`` / ``block_k`` keep the reference's contract:
``None`` resolves through ``ops.pick_attn_blocks`` (tuning cache first,
heuristic on a miss) before the launch; an explicit block is clamped to its
sequence length and must then divide it (``ValueError`` otherwise). The
kernel is instantiated for the tiles of ``ATTN_TILES`` — per head width, the
capacity of one block in queries and keys — and runs a block on the
smallest tile that holds it, masking the rest of the tile; a block that no
tile holds raises ``ValueError`` naming the tiles there are. Head widths other
than those of ``ATTN_TILES`` (64, 128, 256) are zero-padded up to the next
one and the result stripped: zero columns add nothing to q.k^T or to p.v,
and the scale stays that of the true width.

On a CUDA tensor :func:`flash_attention` launches K5 or raises; on a CPU
tensor it runs the same shape and block checks and then the plain version
(:func:`flash_attention_plain`, the oracle ``ref.flash_attention_ref``).
``LAUNCHES`` counts both routes, ``last_launch`` records the block and tile
of the latest kernel launch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import _kernel_operand, _launch

__all__ = ["flash_attention", "flash_attention_plain", "attn_smem_footprint",
           "head_dim_for", "kernel_tile", "ATTN_TILES", "HEAD_DIMS",
           "LAUNCHES", "last_launch", "reset_launches", "launch_counts"]

#: (tile_q, tile_k) the kernel is instantiated for, by head width — the
#: table of csrc/attention.cuh (REPRO_ATTN_TILE). Every tile fits a block's
#: shared memory (``attn_smem_footprint``).
ATTN_TILES = {
    64: ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64), (128, 128)),
    128: ((64, 32), (64, 64), (64, 128), (128, 32), (128, 64)),
    256: ((64, 32), (64, 64)),
}
#: Head widths the kernel is instantiated for; others pad up to the next.
HEAD_DIMS = tuple(sorted(ATTN_TILES))
#: Shared-memory row padding of the staged tiles, in floats (attention.cuh).
ATTN_PAD = 4

#: Launches since the last ``reset_launches()``: ``flash_attention`` where
#: the kernel is launched, ``plain_flash_attention`` for the plain version.
LAUNCHES = {"flash_attention": 0, "plain_flash_attention": 0}

#: Block, tile and shape of the latest kernel launch (empty before one).
last_launch: dict = {}


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launch_counts() -> dict:
    """A snapshot of the launch counters."""
    return dict(LAUNCHES)


def head_dim_for(d: int) -> int:
    """The instantiated head width a width-``d`` problem runs at."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"head dim {d} exceeds the largest the attention kernel "
                     f"is instantiated for ({HEAD_DIMS[-1]})")


def attn_smem_footprint(tile_q: int, tile_k: int, d: int) -> int:
    """Shared-memory bytes of one K5 block: the query tile, the key tile and
    the probability tile transposed and the value tile, all fp32, at the
    instantiated head width of ``d``."""
    width = head_dim_for(d)
    return 4 * (width * (tile_q + ATTN_PAD) + width * (tile_k + ATTN_PAD)
                + tile_k * (width + ATTN_PAD) + tile_k * (tile_q + ATTN_PAD))


def kernel_tile(block_q: int, block_k: int, d: int):
    """The instantiated tile that runs a ``(block_q, block_k)`` block at head
    width ``d``: the smallest one that holds it, or ``None``."""
    fits = [t for t in ATTN_TILES[head_dim_for(d)]
            if t[0] >= block_q and t[1] >= block_k]
    return min(fits, key=lambda t: attn_smem_footprint(*t, d), default=None)


def _check_shapes(q, k, v):
    """Validate (..., Sq, D) / (..., Skv, D); return (sq, skv, d)."""
    if (q.ndim < 2 or k.ndim != q.ndim or v.shape != k.shape
            or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != q.shape[-1]):
        raise ValueError(f"bad attention shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype \
            or q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must share one dtype and one device")
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if sq < 1 or skv < 1 or d < 1:
        raise ValueError(f"attention needs non-empty sequences and heads, "
                         f"got q{tuple(q.shape)} k{tuple(k.shape)}")
    return sq, skv, d


def _blocks(q, sq, skv, d, block_q, block_k):
    """Resolve ``None`` blocks through the tuning cache, clamp, check
    divisibility and find the tile; return (block_q, block_k, tile)."""
    if block_q is None or block_k is None:
        from repro_torch.kernels import ops
        auto_q, auto_k = ops.pick_attn_blocks(sq, skv, d, dtype=q.dtype,
                                              backend=q.device.type)
        block_q = auto_q if block_q is None else block_q
        block_k = auto_k if block_k is None else block_k
    bq, bk = min(int(block_q), sq), min(int(block_k), skv)
    if bq < 1 or bk < 1 or sq % bq or skv % bk:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks "
                         f"({block_q},{block_k})")
    tile = kernel_tile(bq, bk, d)
    if tile is None:
        raise ValueError(
            f"no attention kernel tile holds blocks ({bq},{bk}) at head dim "
            f"{d}: the kernel is instantiated for (tile_q, tile_k) in "
            f"{ATTN_TILES[head_dim_for(d)]}")
    return bq, bk, tile


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None, scale=None,
                          block_q=None, block_k=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: the same shape and
    block checks, then ``ref.flash_attention_ref``."""
    sq, skv, d = _check_shapes(q, k, v)
    _blocks(q, sq, skv, d, block_q, block_k)
    LAUNCHES["plain_flash_attention"] += 1
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None,
                    block_q=None, block_k=None) -> torch.Tensor:
    """Flash attention, q: (..., Sq, D), k/v: (..., Skv, D) — K5.

    Scores in fp32 (``scale``, default ``D ** -0.5``, applied to the fp32
    query), fp32 online softmax — float64 inputs too, as the reference
    computes them — output in ``q.dtype``. Queries are right-aligned
    against the keys; ``causal`` keeps ``k_pos <= q_pos``, ``window`` keeps
    ``k_pos > q_pos - window``; a query row that sees no key returns 0.
    Blocks: see the module docstring. On a CPU tensor this is
    :func:`flash_attention_plain`.
    """
    sq, skv, d = _check_shapes(q, k, v)
    bq, bk, tile = _blocks(q, sq, skv, d, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=bq, block_k=bk)
    what = "flash_attention"
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    lead = q.shape[:-2]
    batch = math.prod(lead)
    if batch == 0:
        return torch.empty_like(q)
    if batch > 65_535:
        raise ValueError(f"{what}: {batch} leading slices exceed the grid's "
                         f"65535 limit on that axis")
    width = head_dim_for(d)
    scale = float(scale) if scale is not None else d ** -0.5
    if window is not None:
        window = int(window)
        if abs(window) >= 2 ** 30:
            raise ValueError(f"{what}: window {window} out of range")

    def stack(x, s):
        x = x.reshape(batch, s, d)
        if width != d:
            x = F.pad(x, (0, width - d))
        return x.contiguous()

    qs, ks, vs = stack(q, sq), stack(k, skv), stack(v, skv)
    for name, t in (("q", qs), ("k", ks), ("v", vs)):
        _kernel_operand(t, name, what)
    out = torch.empty((batch, sq, width), dtype=q.dtype, device=q.device)
    _launch("repro_flash_attention", qs,
            (qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
             sq, skv, width, bq, bk, tile[0], tile[1], batch, int(causal),
             int(window is not None), window or 0, scale))
    LAUNCHES["flash_attention"] += 1
    last_launch.clear()
    last_launch.update(block_q=bq, block_k=bk, tile=tile, sq=sq, skv=skv,
                       d=d, batch=batch)
    if width != d:
        out = out[..., :d]
    return out.reshape(*lead, sq, d)
