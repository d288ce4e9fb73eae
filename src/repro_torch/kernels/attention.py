"""Flash attention (K5): the wrapper, its plain version, the tile tables,
the split-KV rule and combine, and the launch counters.

The port of the reference's ``repro/kernels/attention.py``. Two hand-written
CUDA kernels stand where its Pallas kernel ``_attn_kernel`` stood, both
online-softmax attention over KV tiles with causal and sliding-window masks
and queries right-aligned against the keys, so the Sq x Skv score matrix
never exists in device memory: ``csrc/attention_tc.cuh`` for bf16 / f16 (Q.K^T
and P.V on the tensor cores, ``wgmma`` fed by TMA) and ``csrc/attention.cuh``
for f32 / f64 (exact fp32 FMAs on the CUDA cores). The leading dims of ``q``
(batch, heads) are one grid axis of one launch — the reference's
``jax.vmap`` over one-slice calls.

Blocks and tiles. ``block_q`` / ``block_k`` keep the reference's contract:
``None`` resolves through ``ops.pick_attn_blocks`` (tuning cache first,
heuristic on a miss) before the launch; an explicit block is clamped to its
sequence length and must then divide it (``ValueError`` otherwise). Each
kernel is instantiated for the tiles of its dtype family in ``ATTN_TILES``
(``"tc"`` for bf16 / f16, ``"fma"`` for f32 / f64; per head width, the
capacity of one block in queries and keys), read from the ``.cuh``'s
``REPRO_ATTN_TC_TILE`` / ``REPRO_ATTN_TILE`` lines, and runs a block on the
smallest tile that holds it, masking the rest of the tile; a block that no
tile holds raises ``ValueError`` naming the tiles there are. Head widths other
than ``HEAD_DIMS`` (64, 128, 256) are zero-padded up to the next one and the
result stripped: zero columns add nothing to q.k^T or to p.v, and the scale
stays that of the true width.

Split-KV. When the grid (query tiles x leading slices) is smaller than the
card's SM count, each block's band of KV tiles is cut into ``kv_splits``
chunks on a third grid axis (``kv_range``); each split writes its
unnormalised accumulator and its rows' max and denominator to an fp32
workspace, and ``attn_combine`` (a third kernel, in ``attention.cuh``)
merges them. ``split_partials_plain`` / ``flash_attention_split_plain`` are
the same arithmetic in plain PyTorch. The FMA kernel (f32 / f64) streams
K and V through a ``cp.async`` ring of ``ATTN_FMA_STAGES`` slots per tile.

On a CUDA tensor :func:`flash_attention` launches its dtype's kernel (and
the combine when it splits) or raises; on a CPU tensor it runs the same
shape and block checks and then the plain version
(:func:`flash_attention_plain`, the oracle ``ref.flash_attention_ref``).
``LAUNCHES`` counts every route, ``last_launch`` records the kernel, block,
tile and splits of the latest launch.
"""

from __future__ import annotations

import math
import re
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.matmul import (TC_ALIGN, TC_BARRIER,
                                        _kernel_operand, _launch)

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_split_plain", "split_partials_plain",
           "attn_combine",
           "attn_combine_plain", "attn_smem_footprint", "attn_tiles",
           "head_dim_for", "kernel_tile", "kernel_name", "tile_family",
           "kv_range", "band_tiles", "kv_splits", "sm_count", "ATTN_TILES",
           "HEAD_DIMS", "ATTN_FMA_STAGES", "KERNELS", "LAUNCHES",
           "last_launch", "last_launch_snapshot",
           "reset_launches", "launch_counts"]

_CSRC = Path(__file__).resolve().parent / "csrc"


def _tile_lines(source: str, macro: str) -> list:
    """The ``macro(D, TQ, TK[, STAGES])`` lines of ``csrc/<source>``, in
    their order, as tuples of ints."""
    text = (_CSRC / source).read_text()
    return [tuple(int(x) for x in line.split(", ")) for line in re.findall(
        rf"^\s*{macro}\((\d+(?:, \d+){{2,3}})\)\s*$", text, flags=re.M)]


def _read_tiles(source: str, macro: str) -> dict:
    """``{head width: ((tile_q, tile_k), ...)}`` from the tile lines of
    ``csrc/<source>``, in their order."""
    tiles: dict = {}
    for d, tq, tk, *_ in _tile_lines(source, macro):
        tiles.setdefault(d, []).append((tq, tk))
    return {d: tuple(pairs) for d, pairs in sorted(tiles.items())}


#: (tile_q, tile_k) each kernel is instantiated for, by dtype family and head
#: width: ``"tc"`` the tensor-core kernel of bf16 / f16
#: (csrc/attention_tc.cuh), ``"fma"`` the FMA kernel of f32 / f64
#: (csrc/attention.cuh). Read from the ``.cuh`` lines that instantiate them;
#: every tile fits a block's shared memory (``attn_smem_footprint``).
ATTN_TILES = {"tc": _read_tiles("attention_tc.cuh", "REPRO_ATTN_TC_TILE"),
              "fma": _read_tiles("attention.cuh", "REPRO_ATTN_TILE")}
#: Head widths the kernels are instantiated for (both families); others pad
#: up to the next.
HEAD_DIMS = tuple(sorted(ATTN_TILES["fma"]))
#: Ring slots (each a K or a V tile) of every FMA tile, by (head width,
#: tile_q, tile_k): the fourth number of the ``REPRO_ATTN_TILE`` lines.
ATTN_FMA_STAGES = {(d, tq, tk): st for d, tq, tk, st in
                   _tile_lines("attention.cuh", "REPRO_ATTN_TILE")}
#: Shared-memory row padding of the FMA kernel's Q, K and V tiles and of its
#: P tile, in floats (attention.cuh ``kPad``, ``kPadP``; P's is halved where
#: the score product's d is split across lane pairs), and its threads a
#: block (``kThreads``).
ATTN_PAD = 4
ATTN_PAD_P = 16
ATTN_THREADS = 256
#: K / V ring stages of the tensor-core kernel (attention_tc.cuh).
ATTN_TC_STAGES = 2
#: Multiply a score by this to take it to base 2 (the split workspace's max).
LOG2E = 1.4426950408889634

#: The kernels, by the name their launches are counted under: K5 on the
#: tensor cores (bf16 / f16) or on the FMA pipeline (f32 / f64), and the
#: split-KV combine.
KERNELS = ("flash_attention", "flash_attention_tc", "attn_combine")

#: Launches since the last ``reset_launches()``: each kernel where it is
#: launched, ``plain_flash_attention`` / ``plain_attn_combine`` for the
#: plain versions.
LAUNCHES = {**{name: 0 for name in KERNELS}, "plain_flash_attention": 0,
            "plain_attn_combine": 0}

#: Kernel, block, tile, splits and shape of the latest kernel launch (empty
#: before one). While other threads launch, read it through
#: ``last_launch_snapshot()``.
last_launch: dict = {}

# Guards LAUNCHES and last_launch against launches from several threads.
_COUNT_LOCK = threading.Lock()

_SMS: dict = {}


def _count(name: str, **launch) -> None:
    """Count one launch of ``name``; with ``launch`` given, make it
    ``last_launch`` under the same lock."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if launch:
            last_launch.clear()
            last_launch.update(kernel=name, **launch)


def reset_launches() -> None:
    """Set every launch counter to 0."""
    with _COUNT_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launch_counts() -> dict:
    """A consistent snapshot of the launch counters."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def last_launch_snapshot() -> dict:
    """A consistent copy of ``last_launch``."""
    with _COUNT_LOCK:
        return dict(last_launch)


def tile_family(dtype) -> str:
    """``"tc"`` for the 16-bit types (the tensor-core kernel), ``"fma"``
    else."""
    return "tc" if dtype in (torch.bfloat16, torch.float16) else "fma"


def attn_tiles(dtype) -> dict:
    """The tile table of the kernel that runs ``dtype``."""
    return ATTN_TILES[tile_family(dtype)]


def kernel_name(dtype) -> str:
    """The counter of ``KERNELS`` that K5 on ``dtype`` operands goes to."""
    return "flash_attention_tc" if tile_family(dtype) == "tc" \
        else "flash_attention"


def head_dim_for(d: int) -> int:
    """The instantiated head width a width-``d`` problem runs at."""
    for width in HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"head dim {d} exceeds the largest the attention kernel "
                     f"is instantiated for ({HEAD_DIMS[-1]})")


def attn_smem_footprint(tile_q: int, tile_k: int, d: int,
                        dtype=torch.float32) -> int:
    """Shared-memory bytes one K5 block asks for, at the instantiated head
    width of ``d``. 16-bit (attention_tc.cuh ``Smem``): the Q tile and
    ``ATTN_TC_STAGES`` stages of K and V tiles in the storage type, a full
    and an empty barrier per stage and one for Q, after the alignment
    slack. f32 / f64 (attention.cuh ``Layout``): the query tile, the
    tile's ``ATTN_FMA_STAGES`` ring slots of K or V tiles, rows padded by
    ``ATTN_PAD``, and the probability tile, rows padded by ``ATTN_PAD_P``
    (half of it where a thread's share of the score tile is under 64 and
    the kernel splits d across lane pairs), all fp32. A tile that is not
    instantiated raises ``KeyError``."""
    width = head_dim_for(d)
    if tile_family(dtype) == "tc":
        return (TC_ALIGN + tile_q * width * 2
                + ATTN_TC_STAGES * 2 * tile_k * width * 2
                + (2 * ATTN_TC_STAGES + 1) * TC_BARRIER)
    stages = ATTN_FMA_STAGES[(width, tile_q, tile_k)]
    split = 2 if tile_q * tile_k < 64 * ATTN_THREADS else 1
    return 4 * ((tile_q + stages * tile_k) * (width + ATTN_PAD)
                + tile_q * (tile_k + ATTN_PAD_P // split))


def kernel_tile(block_q: int, block_k: int, d: int, dtype=torch.float32):
    """The instantiated tile that runs a ``(block_q, block_k)`` block at head
    width ``d`` on ``dtype``'s kernel: the smallest one that holds it, or
    ``None``."""
    fits = [t for t in attn_tiles(dtype)[head_dim_for(d)]
            if t[0] >= block_q and t[1] >= block_k]
    return min(fits, key=lambda t: attn_smem_footprint(*t, d, dtype),
               default=None)


def kv_range(q0: int, rows: int, sq: int, skv: int, bk: int, causal: bool,
             window=None, split: int = 0, splits: int = 1) -> tuple:
    """``(first key, tiles)`` a block visits: the KV tiles of ``bk`` keys
    that meet the causal / window band of its ``rows`` queries from ``q0``
    (queries right-aligned against the keys), from the tile holding key
    ``q_lo - window + 1`` to the one holding key ``q_hi``; of them, split
    ``split`` of ``splits`` takes the split-th chunk of
    ``ceil(tiles / splits)``. Every chunk starts on a multiple of ``bk``. The
    kernels' ``kv_range`` (csrc/attention.cuh) is the same function."""
    shift = skv - sq
    q_lo, q_hi = q0 + shift, q0 + rows - 1 + shift
    kv_begin = max(0, q_lo - window + 1) if window is not None else 0
    kv_end = min(skv, q_hi + 1) if causal else skv
    if kv_end <= kv_begin:
        return 0, 0
    first = kv_begin // bk * bk
    band = -(-(kv_end - first) // bk)
    chunk = -(-band // splits)
    t0 = min(band, split * chunk)
    return first + t0 * bk, min(band, t0 + chunk) - t0


def band_tiles(sq: int, skv: int, bq: int, bk: int, causal: bool,
               window=None) -> int:
    """The most KV tiles any query block's band holds."""
    return max(kv_range(q0, min(bq, sq - q0), sq, skv, bk, causal, window)[1]
               for q0 in range(0, sq, bq))


def kv_splits(q_tiles: int, batch: int, band: int, sms: int) -> int:
    """How many chunks to cut each block's band of ``band`` KV tiles into:
    1 when the grid's ``q_tiles * batch`` blocks fill the ``sms`` SMs;
    else enough for about two blocks per SM, ``ceil(2 sms / blocks)``, never
    more than the band's tiles, and no more than its chunks of
    ``ceil(band / splits)`` tiles need (so no split of the longest band is
    empty)."""
    blocks = q_tiles * batch
    if blocks >= sms or band <= 1:
        return 1
    want = min(band, -(-2 * sms // blocks))
    chunk = -(-band // want)
    return -(-band // chunk)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


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
    divisibility and find the tile of ``q.dtype``'s kernel; return
    (block_q, block_k, tile)."""
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
    tile = kernel_tile(bq, bk, d, q.dtype)
    if tile is None:
        raise ValueError(
            f"no attention kernel tile holds blocks ({bq},{bk}) at head dim "
            f"{d}: the {q.dtype} kernel is instantiated for (tile_q, tile_k) "
            f"in {attn_tiles(q.dtype)[head_dim_for(d)]}")
    return bq, bk, tile


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None, scale=None,
                          block_q=None, block_k=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: the same shape and
    block checks, then ``ref.flash_attention_ref``."""
    sq, skv, d = _check_shapes(q, k, v)
    _blocks(q, sq, skv, d, block_q, block_k)
    _count("plain_flash_attention")
    return _ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    scale=scale)


def attn_combine_plain(part_o: torch.Tensor, part_ml: torch.Tensor,
                       dtype) -> torch.Tensor:
    """Plain PyTorch version of :func:`attn_combine`: merge the ``splits``
    partial results of a split-KV launch. ``part_o`` (splits, rows, width)
    holds each split's unnormalised accumulator, ``part_ml`` (splits, rows,
    2) its rows' max in base 2 and denominator, all fp32. With m* the max
    over splits and w_s = 2^(m_s - m*) (0 where m_s = -inf: a split that saw
    no key), the result is sum_s w_s acc_s / sum_s w_s l_s, exactly 0 where
    the denominator is 0, in ``dtype``."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    m_max = m.amax(0)
    w = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - m_max))
    den = (w * l).sum(0)[..., None]
    num = (w[..., None] * part_o).sum(0)
    _count("plain_attn_combine")
    return torch.where(den == 0, torch.zeros_like(num), num / den).to(dtype)


def attn_combine(part_o: torch.Tensor, part_ml: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """Merge the splits of a split-KV launch into ``out`` (rows, width), in
    its dtype — the combine kernel of csrc/attention.cuh, or on CPU tensors
    :func:`attn_combine_plain`. Returns ``out``."""
    splits, rows, width = part_o.shape
    if (part_o.dtype != torch.float32 or part_ml.dtype != torch.float32
            or tuple(part_ml.shape) != (splits, rows, 2)
            or tuple(out.shape) != (rows, width)
            or len({part_o.device, part_ml.device, out.device}) != 1):
        raise ValueError(
            f"attn_combine: partials must be fp32 (splits, rows, width) and "
            f"(splits, rows, 2), out (rows, width), on one device; got "
            f"{tuple(part_o.shape)} {part_o.dtype}, {tuple(part_ml.shape)} "
            f"{part_ml.dtype}, out {tuple(out.shape)}")
    if out.device.type == "cpu":
        out.copy_(attn_combine_plain(part_o, part_ml, out.dtype))
        return out
    if width > max(HEAD_DIMS):
        raise ValueError(f"attn_combine: width {width} above "
                         f"{max(HEAD_DIMS)}")
    for name, t in (("part_o", part_o), ("part_ml", part_ml), ("out", out)):
        _kernel_operand(t, name, "attn_combine")
    _launch("repro_attn_combine", out,
            (part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), splits,
             rows, width))
    _count("attn_combine")
    return out


def split_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window=None, scale=None,
                         block_q: int, block_k: int, splits: int) -> tuple:
    """What the kernels' splits write, in plain PyTorch and fp32: every
    ``block_q`` block of queries visits its band of ``block_k`` KV tiles cut
    into ``splits`` chunks (``kv_range``); each chunk yields its rows'
    unnormalised accumulator and their max (base 2) and denominator.
    Returns ``(part_o, part_ml)`` shaped (splits, rows, d) and (splits, rows,
    2), rows = the leading slices times Sq, as :func:`attn_combine` takes
    them. Blocks must divide the lengths (no tile check: this is the
    arithmetic, not a launch)."""
    sq, skv, d = _check_shapes(q, k, v)
    if sq % block_q or skv % block_k:
        raise ValueError(f"seq lens ({sq},{skv}) not divisible by blocks "
                         f"({block_q},{block_k})")
    scale = d ** -0.5 if scale is None else float(scale)
    qf, kf, vf = (x.reshape(-1, x.shape[-2], d).float() for x in (q, k, v))
    batch = qf.shape[0]
    scores = (qf @ kf.transpose(-1, -2)) * (scale * LOG2E)
    q_pos = torch.arange(sq)[:, None] + (skv - sq)
    k_pos = torch.arange(skv)[None, :]
    visible = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        visible &= k_pos <= q_pos
    if window is not None:
        visible &= k_pos > q_pos - window
    visible = visible.to(q.device)
    part_o = torch.zeros((splits, batch, sq, d), device=q.device)
    part_ml = torch.zeros((splits, batch, sq, 2), device=q.device)
    part_ml[..., 0] = -math.inf
    for q0 in range(0, sq, block_q):
        rows = slice(q0, q0 + block_q)
        for z in range(splits):
            first, tiles = kv_range(q0, block_q, sq, skv, block_k, causal,
                                    window, z, splits)
            if tiles == 0:
                continue
            keys = slice(first, min(skv, first + tiles * block_k))
            s = scores[:, rows, keys].masked_fill(~visible[rows, keys],
                                                  -math.inf)
            m = s.amax(-1)
            p = torch.exp2(s - torch.where(m == -math.inf,
                                           torch.zeros_like(m), m)[..., None])
            part_o[z, :, rows] = p @ vf[:, keys]
            part_ml[z, :, rows, 0] = m
            part_ml[z, :, rows, 1] = p.sum(-1)
    return (part_o.reshape(splits, batch * sq, d),
            part_ml.reshape(splits, batch * sq, 2))


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window=None, scale=None, block_q: int,
                                block_k: int, splits: int) -> torch.Tensor:
    """The split-KV arithmetic of the kernels in plain PyTorch:
    :func:`split_partials_plain`, then :func:`attn_combine_plain`."""
    part_o, part_ml = split_partials_plain(
        q, k, v, causal=causal, window=window, scale=scale, block_q=block_q,
        block_k=block_k, splits=splits)
    return attn_combine_plain(part_o, part_ml, q.dtype).reshape(q.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, scale=None,
                    block_q=None, block_k=None) -> torch.Tensor:
    """Flash attention, q: (..., Sq, D), k/v: (..., Skv, D) — K5.

    Scores in fp32 (``scale``, default ``D ** -0.5``), fp32 online softmax —
    float64 inputs too, as the reference computes them — output in
    ``q.dtype``. Queries are right-aligned against the keys; ``causal``
    keeps ``k_pos <= q_pos``, ``window`` keeps ``k_pos > q_pos - window``; a
    query row that sees no key returns 0. bf16 / f16 run the tensor-core
    kernel (``flash_attention_tc``), f32 / f64 the FMA kernel
    (``flash_attention``); a grid too small for the card splits the KV
    bands and launches ``attn_combine`` after. Blocks: see the module
    docstring. On a CPU tensor this is :func:`flash_attention_plain`.
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
    q_tiles = -(-sq // bq)
    if max(batch, q_tiles) > 65_535:
        raise ValueError(f"{what}: {batch} leading slices or {q_tiles} query "
                         f"blocks exceed the grid's 65535 limit on an axis")
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
    splits = 1
    sms = sm_count(q.device)
    if q_tiles * batch < sms:
        splits = kv_splits(q_tiles, batch,
                           band_tiles(sq, skv, bq, bk, causal, window), sms)
    out = torch.empty((batch, sq, width), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((splits, batch * sq, width), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((splits, batch * sq, 2), dtype=torch.float32,
                              device=q.device)
    name = kernel_name(q.dtype)
    _launch("repro_flash_attention", qs,
            (qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
             None if part_o is None else part_o.data_ptr(),
             None if part_ml is None else part_ml.data_ptr(),
             sq, skv, width, bq, bk, tile[0], tile[1], batch, splits,
             int(causal), int(window is not None), window or 0, scale))
    _count(name, block_q=bq, block_k=bk, tile=tile, splits=splits, sq=sq,
           skv=skv, d=d, batch=batch)
    if splits > 1:
        attn_combine(part_o, part_ml, out.view(batch * sq, width))
    if width != d:
        out = out[..., :d]
    return out.reshape(*lead, sq, d)
