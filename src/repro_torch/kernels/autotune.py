"""Persistent tuning subsystem for the port's kernels.

The port of the reference's ``repro/kernels/autotune.py``: the same
namespaced JSON cache, entry validation, generation counter and sweeps, with
the TPU's VMEM model replaced by the H100's shared memory and wall-clock
timing replaced by CUDA events. The 2012 paper sweeps tile sizes per
problem ("an appropriate TILE size is used based on the problem and local
memory available"); this module records the winners so every kernel call
picks tuned tiles for free.

Namespaces (the ``kernel`` key segment, ``KERNELS``):

  * ``matmul``       — ``(block_m, block_n, block_k)`` tilings of K1–K3;
                       consulted by ``ops.pick_blocks`` (``ops.matmul``,
                       ``ops.square``, ``ops.MatmulChain``).
  * ``attention``    — ``(block_q, block_k)`` blocks of K5, keyed on
                       ``(sq, skv, d)``; consulted by ``ops.pick_attn_blocks``
                       and so by ``flash_attention`` / ``ops.attention``.
  * ``square_panel`` — the squaring tier limits (``square_tiers``):
                       operand bytes up to which K2 (whole operand in shared
                       memory) and K3 (row panel) serve a squaring.
  * ``dispatch``     — the serving engine's route thresholds
                       (``dispatch_thresholds``: buckets up to ``cpu_max_n``
                       take the ``"torch"`` route, the rest the kernel
                       chain) and its per-traffic-class flush deadlines
                       (``bucket_deadline_ms``); read by
                       ``repro_torch.serve.matfn``. The defaults are the
                       reference's; nothing here sweeps them yet.
  * ``fastmm``       — the Strassen route's ``(crossover_n, max_levels)``
                       and optional leaf tiles (``fastmm_config``); read by
                       ``kernels.fastmm`` and ``ops.MatmulChain(fast=...)``,
                       and by the engine, whose buckets above the crossover
                       take the ``fastmm`` route. ``sweep_fastmm`` measures
                       the crossover on the card.
  * ``markov``       — the B/n ratio above which ``core.markov.
                       evolve_distributions`` leaves its vector–matrix loop
                       for one dense power and one apply
                       (``markov_evolve_threshold``).

Keys are ``{kernel}/{dims}/{dtype}/{backend}``. The backend segment is the
operand's device type (``"cuda"`` or ``"cpu"``), passed by the caller; it
defaults to ``"cuda"``, the port's default device, and building a key never
probes for a GPU.

The cache file is the port's own: ``~/.cache/repro/autotune_torch.json``,
or ``$REPRO_TORCH_AUTOTUNE_CACHE``, so the two packages never read each
other's entries. Writes are atomic; a corrupted or partly invalid file
degrades to an empty or filtered cache instead of raising. Every mutation
bumps a process-wide generation counter (``cache_generation``) that
long-lived consumers key their memos on.

Sweeps score candidates by measuring them on the card or, off it, by an
analytic model; ``measure=None`` measures on ``"cuda"`` and models
otherwise. A measurement is the device time of one call
(``device_times_us``: CUDA-event medians over replays of a CUDA graph of
back-to-back calls, after an untimed first call that builds the kernels'
library), so host jitter does not rank kernels of a few microseconds. A
measurement that finds no card raises — it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import os
import warnings
from pathlib import Path
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.attention import (ATTN_TILES, HEAD_DIMS,
                                           attn_smem_footprint, head_dim_for,
                                           kernel_tile)
from repro_torch.kernels.matmul import (DMMA_BLOCKS, F32_BLOCKS, SM_COUNT,
                                        SMEM_PER_BLOCK, SQUARE_PANEL_LIMIT,
                                        SQUARE_SMEM_LIMIT, TC_BLOCKS,
                                        panel_smem_footprint,
                                        smem_footprint)

__all__ = [
    "cache_path", "load_cache", "save_cache", "clear_memory_cache",
    "lookup", "record", "sweep", "DEFAULT_CANDIDATES", "TC_CANDIDATES",
    "DMMA_CANDIDATES",
    "valid_blocks",
    "smem_footprint",
    "KERNELS", "DEFAULT_ATTN_CANDIDATES", "TC_ATTN_CANDIDATES",
    "attn_candidates", "attn_smem_footprint",
    "attn_blocks_usable", "modeled_score", "modeled_attn_score",
    "measure_us", "measure_attn_us", "sweep_attention",
    "DEFAULT_SQUARE_TIERS", "square_tiers", "record_square_tiers",
    "sweep_square_tiers", "device_times_us",
    "DEFAULT_DISPATCH_THRESHOLDS", "DEFAULT_MAX_DELAY_MS",
    "DEFAULT_FASTMM_CROSSOVER", "DEFAULT_FASTMM_LEVELS",
    "dispatch_thresholds",
    "record_dispatch_thresholds", "bucket_deadline_ms",
    "record_bucket_deadline", "fastmm_config", "record_fastmm",
    "sweep_fastmm", "DEFAULT_MARKOV_EVOLVE_THRESHOLD",
    "markov_evolve_threshold", "record_markov_evolve_threshold",
    "cache_generation", "on_generation_bump",
]

_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"

#: Kernel namespaces the cache knows about (the first segment of every key).
KERNELS = ("matmul", "attention", "square_panel", "dispatch", "fastmm",
           "markov")

#: Matmul candidates of the f32 FMA kernel: every instantiated (tile,
#: K step) pair.
DEFAULT_CANDIDATES: tuple = tuple((t, t, bk) for t, bk in F32_BLOCKS)

#: Matmul candidates of the 16-bit tensor-core kernels: every instantiated
#: (tile, K step) pair.
TC_CANDIDATES: tuple = tuple((t, t, bk) for t, bk in TC_BLOCKS)

#: The same for the fp64 tensor-core K1.
DMMA_CANDIDATES: tuple = tuple((t, t, bk) for t, bk in DMMA_BLOCKS)

#: (block_q, block_k) candidates of the f32 / f64 FMA attention kernel: its
#: instantiated tiles (the widest head dims take only some; the others
#: score inf there).
DEFAULT_ATTN_CANDIDATES: tuple = tuple(sorted(
    {t for tiles in ATTN_TILES["fma"].values() for t in tiles}))

#: The same for the 16-bit tensor-core attention kernel.
TC_ATTN_CANDIDATES: tuple = tuple(sorted(
    {t for tiles in ATTN_TILES["tc"].values() for t in tiles}))

#: Default squaring tier limits (operand bytes): K2 up to the first, K3 up
#: to the second, K1 above. Overridable per dtype/backend through the
#: ``square_panel`` namespace.
DEFAULT_SQUARE_TIERS: tuple = (SQUARE_SMEM_LIMIT, SQUARE_PANEL_LIMIT)

#: Default route thresholds ``(cpu_max_n, sharded_min_n)`` of the serving
#: engine: buckets with n <= cpu_max_n take the ``"torch"`` route (cuBLAS on
#: the card), the rest the kernel chain; ``sharded_min_n`` is kept for the
#: sharded route, which is not ported. The reference's values, kept until a
#: measurement on the card re-derives them. Overridable per dtype through
#: the ``dispatch`` namespace.
DEFAULT_DISPATCH_THRESHOLDS: tuple = (64, 4096)

#: Default continuous-batching flush deadline (milliseconds): how long a
#: partly filled serving bucket may wait for more requests before it runs
#: anyway; per-(op, n, dtype) ``dispatch`` entries override it
#: (``bucket_deadline_ms``).
DEFAULT_MAX_DELAY_MS: float = 2.0

#: Default Strassen crossover (matrix size n), the reference's: multiplies
#: with n above it recurse one Strassen level (7 half-size products, about
#: one bit of accuracy a level) until a sub-problem reaches the crossover or
#: the level cap; serving buckets with n above it take the ``fastmm`` route.
#: ``sweep_fastmm`` measures it per dtype and backend.
DEFAULT_FASTMM_CROSSOVER: int = 1024

#: Default Strassen depth cap: every level costs about a bit of accuracy
#: and more operand sums, so depth is capped apart from the crossover.
DEFAULT_FASTMM_LEVELS: int = 2

#: Default evolve-versus-dense ratio of ``core.markov.evolve_distributions``:
#: the evolve loop's extra O(B n^2) vector–matrix products beat the dense
#: route's saved O(n^3) combines roughly while B <= n.
DEFAULT_MARKOV_EVOLVE_THRESHOLD: float = 1.0

#: Samples per side of a squaring-tier probe (``sweep_square_tiers``).
TIER_PROBE_REPS = 7

#: (Sq, D) slices an attention measurement stacks into one launch: one slice
#: alone leaves most of the 132 SMs idle (16 is Qwen3-1.7B's query heads).
ATTN_SWEEP_HEADS = 16

# In-memory image of each cache file, keyed by resolved path.
_MEM: dict = {}

# Process-wide mutation counter for the cache (see ``cache_generation``).
_GENERATION = 0

# Listeners notified after every generation bump (see ``on_generation_bump``).
_GENERATION_LISTENERS: list = []


# ---------------------------------------------------------------------------
# Generation counter
# ---------------------------------------------------------------------------

def cache_generation() -> int:
    """Monotone counter bumped on every cache mutation in this process.

    Covers ``record*`` calls, ``save_cache``, ``clear_memory_cache`` (the
    way to pick up an external file edit) and fresh disk reads. Consumers
    that memoize resolved entries compare generations instead of re-reading
    the cache on every call.
    """
    return _GENERATION


def on_generation_bump(listener):
    """Register ``listener(generation, reason)`` to fire after every cache
    mutation; returns an unsubscribe callable. Listeners run synchronously
    on the mutating thread; an exception in one is swallowed, so a broken
    observer never takes down a retune."""
    _GENERATION_LISTENERS.append(listener)

    def unsubscribe() -> None:
        try:
            _GENERATION_LISTENERS.remove(listener)
        except ValueError:
            pass

    return unsubscribe


def _bump_generation(reason: str = "mutation") -> None:
    global _GENERATION
    _GENERATION += 1
    for listener in list(_GENERATION_LISTENERS):
        try:
            listener(_GENERATION, reason)
        except Exception:   # noqa: BLE001 — observers must never break a retune
            pass


# ---------------------------------------------------------------------------
# Keys and entries
# ---------------------------------------------------------------------------

def cache_path() -> Path:
    """Resolve the on-disk cache location (the environment variable wins)."""
    override = os.environ.get(_ENV_VAR)
    if override:
        return Path(override).expanduser()
    return Path.home() / ".cache" / "repro" / "autotune_torch.json"


def _dtype_key(dtype) -> str:
    if dtype is None:
        return "any"
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _backend(backend: Optional[str]) -> str:
    return backend or "cuda"


def _key(m: int, n: int, k: int, dtype=None, backend: Optional[str] = None,
         kernel: str = "matmul") -> str:
    return f"{kernel}/{m}x{n}x{k}/{_dtype_key(dtype)}/{_backend(backend)}"


def _tiers_key(dtype=None, backend: Optional[str] = None) -> str:
    return f"square_panel/tiers/{_dtype_key(dtype)}/{_backend(backend)}"


def _dispatch_key(dtype=None, backend: Optional[str] = None) -> str:
    return f"dispatch/thresholds/{_dtype_key(dtype)}/{_backend(backend)}"


def _fastmm_key(dtype=None, backend: Optional[str] = None) -> str:
    return f"fastmm/config/{_dtype_key(dtype)}/{_backend(backend)}"


def _markov_key(dtype=None, backend: Optional[str] = None) -> str:
    return f"markov/evolve/{_dtype_key(dtype)}/{_backend(backend)}"


def _deadline_key(op: str, n: int, dtype=None,
                  backend: Optional[str] = None) -> str:
    return (f"dispatch/deadline/{op}/{n}/{_dtype_key(dtype)}/"
            f"{_backend(backend)}")


def _ascending_pair(vals) -> bool:
    return (len(vals) == 2
            and all(isinstance(x, int) and x > 0 for x in vals)
            and vals[0] <= vals[1])


def _positive_number(v) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v) and v > 0)


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _leaf_ok(leaf, dtype) -> bool:
    """A Strassen leaf tiling: None, or three positive ints that K1 runs
    for ``dtype`` (``valid_blocks``; float32 when None or unknown)."""
    if leaf is None:
        return True
    if len(leaf) != 3 or not all(_is_int(x) and x > 0 for x in leaf):
        return False
    try:
        itemsize = _itemsize(getattr(torch, dtype) if isinstance(dtype, str)
                             else dtype)
    except (AttributeError, TypeError):
        itemsize = 4
    return valid_blocks(tuple(leaf), itemsize)


def _valid_entry(entry, key: Optional[str] = None) -> bool:
    """A usable cache entry: a block tiling (len 2 for attention, len 3 for
    matmul), a ``square_panel`` tier pair or a ``dispatch`` threshold pair
    (both two ascending positive ints), a ``dispatch`` deadline (one
    positive finite ``max_delay_ms``), a ``fastmm`` config
    (``[crossover_n, max_levels]``, a positive and a non-negative int, and
    ``leaf_blocks`` None or a tiling K1 runs for the dtype the ``key``
    names), or a ``markov`` entry (one positive finite
    ``evolve_threshold``)."""
    try:
        if "tiers" in entry:
            return _ascending_pair(entry["tiers"])
        if "thresholds" in entry:
            return _ascending_pair(entry["thresholds"])
        if "max_delay_ms" in entry:
            return _positive_number(entry["max_delay_ms"])
        if "evolve_threshold" in entry:
            return _positive_number(entry["evolve_threshold"])
        if "fastmm" in entry:
            cfg = entry["fastmm"]
            parts = (key or "").split("/")
            dtype = parts[2] if len(parts) == 4 and parts[2] != "any" \
                else None
            return (len(cfg) == 2 and _is_int(cfg[0]) and cfg[0] > 0
                    and _is_int(cfg[1]) and cfg[1] >= 0
                    and _leaf_ok(entry.get("leaf_blocks"), dtype))
        blocks = entry["blocks"]
        return (len(blocks) in (2, 3)
                and all(isinstance(x, int) and x > 0 for x in blocks))
    except (TypeError, KeyError):
        return False


def valid_blocks(blocks, itemsize: int = 4) -> bool:
    """Whether a matmul tiling can run on the kernels: a square output tile
    with a footprint within a block's shared memory (227 KB, above which the
    launch is refused) and a (tile, K step) pair the dtype's K1 is
    instantiated for: ``TC_BLOCKS`` for 16-bit operands (``itemsize`` 2),
    ``DMMA_BLOCKS`` for f64, ``F32_BLOCKS`` else."""
    bm, bn, bk = blocks
    table = {2: TC_BLOCKS, 8: DMMA_BLOCKS}.get(itemsize, F32_BLOCKS)
    return (bm, bk) in table and bm == bn \
        and smem_footprint(blocks, itemsize) <= SMEM_PER_BLOCK


def attn_candidates(dtype=None) -> tuple:
    """The attention sweep's default candidates for ``dtype``'s kernel."""
    return TC_ATTN_CANDIDATES if _itemsize(dtype) == 2 \
        else DEFAULT_ATTN_CANDIDATES


def attn_blocks_usable(sq: int, skv: int, d: int, blocks,
                       dtype=None) -> bool:
    """Whether ``(block_q, block_k)`` can run K5 on an (sq, skv, d) problem
    in ``dtype`` (float32 when None): each block clamped to its length
    divides it, and an instantiated tile of that dtype's kernel that fits a
    block's shared memory holds the pair (``d`` at most the widest
    instantiated head width)."""
    bq, bk = (min(int(blocks[0]), sq), min(int(blocks[1]), skv))
    if bq < 1 or bk < 1 or sq % bq or skv % bk or d > max(HEAD_DIMS):
        return False
    tile = kernel_tile(bq, bk, d, dtype)
    return tile is not None and \
        attn_smem_footprint(*tile, d, dtype) <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# The cache file
# ---------------------------------------------------------------------------

def load_cache(path: Optional[os.PathLike] = None) -> dict:
    """Read (and memoize) the cache file; corrupted files degrade to {}."""
    path = Path(path) if path is not None else cache_path()
    memo_key = str(path)
    if memo_key in _MEM:
        return _MEM[memo_key]
    data: dict = {}
    if path.exists():
        try:
            raw = json.loads(path.read_text())
            if not isinstance(raw, dict):
                raise ValueError("cache root must be a JSON object")
            data = {k: v for k, v in raw.items() if _valid_entry(v, k)}
        except (ValueError, OSError) as exc:
            warnings.warn(f"ignoring corrupted autotune cache {path}: {exc}")
            data = {}
    _MEM[memo_key] = data
    _bump_generation("load")  # fresh disk read: memoized resolutions are stale
    return data


def save_cache(cache: Optional[dict] = None,
               path: Optional[os.PathLike] = None) -> Path:
    """Atomically persist the cache (tmp file + rename). An unwritable
    location degrades to a warning: the results stay usable in-process."""
    path = Path(path) if path is not None else cache_path()
    if cache is None:
        cache = _MEM.get(str(path), {})
    _MEM[str(path)] = cache
    _bump_generation("save")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(json.dumps(cache, indent=2, sort_keys=True))
        os.replace(tmp, path)
    except OSError as exc:
        warnings.warn(f"could not persist autotune cache to {path}: {exc}")
    return path


def clear_memory_cache() -> None:
    """Drop the in-process memo (tests; picks up external file edits)."""
    _MEM.clear()
    _bump_generation("clear")


def _store(key: str, entry: dict, reason: str, save: bool) -> None:
    cache = load_cache()
    cache[key] = entry
    _bump_generation(reason)
    if save:
        save_cache(cache)


def _first(keys, field: str):
    """The first valid entry among ``keys`` that has ``field``, or None."""
    cache = load_cache()
    for key in keys:
        entry = cache.get(key)
        if entry is not None and _valid_entry(entry, key) and field in entry:
            return entry
    return None


# ---------------------------------------------------------------------------
# Block namespaces (matmul, attention)
# ---------------------------------------------------------------------------

def lookup(m: int, n: int, k: int, dtype=None,
           backend: Optional[str] = None,
           kernel: str = "matmul") -> Optional[tuple]:
    """Tuned blocks for the ``kernel``-namespace problem key, or ``None``.

    For attention the three dims are ``(sq, skv, d)`` and the entry is
    ``(block_q, block_k)``. A dtype-specific entry wins over a
    dtype-agnostic (``any``) one. Entries whose block count does not match
    the namespace (3 for matmul, 2 for attention) are skipped. Callers
    re-validate the blocks against the kernels (``ops.pick_blocks``,
    ``ops.pick_attn_blocks``): the cache is advisory.
    """
    want_len = 2 if kernel == "attention" else 3
    for key in (_key(m, n, k, dtype, backend, kernel),
                _key(m, n, k, None, backend, kernel)):
        entry = _first([key], "blocks")
        if entry is not None and len(entry["blocks"]) == want_len:
            return tuple(entry["blocks"])
    return None


def record(m: int, n: int, k: int, blocks: Sequence[int], dtype=None,
           backend: Optional[str] = None, score: Optional[float] = None,
           measured: bool = False, save: bool = True,
           kernel: str = "matmul") -> None:
    """Store the winning blocks for a problem key (and persist by default).

    ``measured`` records provenance: ``True`` for winners timed on the
    card, ``False`` for the analytic model. ``score`` is the winning metric
    (µs when measured, the unitless model score otherwise).
    """
    _store(_key(m, n, k, dtype, backend, kernel),
           {"blocks": [int(x) for x in blocks],
            "score": None if score is None else float(score),
            "measured": bool(measured)},
           f"record:{kernel}", save)


# ---------------------------------------------------------------------------
# Squaring tiers
# ---------------------------------------------------------------------------

def square_tiers(dtype=None, backend: Optional[str] = None) -> tuple:
    """(whole_limit, panel_limit) operand-byte limits of the squaring tiers:
    the ``square_panel`` entry for this dtype, then the dtype-agnostic one,
    then ``DEFAULT_SQUARE_TIERS``."""
    entry = _first((_tiers_key(dtype, backend), _tiers_key(None, backend)),
                   "tiers")
    return tuple(entry["tiers"]) if entry else DEFAULT_SQUARE_TIERS


def record_square_tiers(whole_limit: int, panel_limit: int, dtype=None,
                        backend: Optional[str] = None, measured: bool = False,
                        save: bool = True,
                        probes_us: Optional[dict] = None) -> None:
    """Store tuned squaring tier limits (operand bytes); ``probes_us``, the
    measured sweep's median times, is kept beside them as provenance."""
    if not (0 < whole_limit <= panel_limit):
        raise ValueError(f"tiers must be ascending positive ints, got "
                         f"({whole_limit}, {panel_limit})")
    entry = {"tiers": [int(whole_limit), int(panel_limit)],
             "measured": bool(measured)}
    if probes_us is not None:
        entry["probes_us"] = dict(probes_us)
    _store(_tiers_key(dtype, backend), entry,
           "record:square_panel", save)


# ---------------------------------------------------------------------------
# The serving engine's dispatch namespace
# ---------------------------------------------------------------------------

def dispatch_thresholds(dtype=None, backend: Optional[str] = None) -> tuple:
    """(cpu_max_n, sharded_min_n) for the serving engine's route choice
    (``repro_torch.serve.matfn``): the ``dispatch`` entry for this dtype,
    then the dtype-agnostic one, then ``DEFAULT_DISPATCH_THRESHOLDS``."""
    entry = _first((_dispatch_key(dtype, backend),
                    _dispatch_key(None, backend)), "thresholds")
    return tuple(entry["thresholds"]) if entry else \
        DEFAULT_DISPATCH_THRESHOLDS


def record_dispatch_thresholds(cpu_max_n: int, sharded_min_n: int,
                               dtype=None, backend: Optional[str] = None,
                               measured: bool = False,
                               save: bool = True) -> None:
    """Store route thresholds (matrix sizes); ``measured`` records whether a
    sweep on the card timed them."""
    if not (0 < cpu_max_n <= sharded_min_n):
        raise ValueError(f"dispatch thresholds must be ascending positive "
                         f"ints, got ({cpu_max_n}, {sharded_min_n})")
    _store(_dispatch_key(dtype, backend),
           {"thresholds": [int(cpu_max_n), int(sharded_min_n)],
            "measured": bool(measured)},
           "record:dispatch", save)


def bucket_deadline_ms(op: str, n: int, dtype=None,
                       backend: Optional[str] = None) -> float:
    """Flush deadline (ms) of one serving traffic class: how long the daemon
    lets a partly filled ``(op, n, dtype)`` bucket wait for more requests.
    The ``dispatch`` deadline entry for this dtype, then the dtype-agnostic
    one, then ``DEFAULT_MAX_DELAY_MS``."""
    entry = _first((_deadline_key(op, n, dtype, backend),
                    _deadline_key(op, n, None, backend)), "max_delay_ms")
    return float(entry["max_delay_ms"]) if entry else DEFAULT_MAX_DELAY_MS


def record_bucket_deadline(op: str, n: int, max_delay_ms: float, dtype=None,
                           backend: Optional[str] = None,
                           measured: bool = False, save: bool = True) -> None:
    """Store a flush deadline for one serving traffic class."""
    if not isinstance(op, str) or not op:
        raise ValueError(f"op must be a non-empty string, got {op!r}")
    if not isinstance(n, int) or isinstance(n, bool) or n < 1:
        raise ValueError(f"n must be a positive int, got {n!r}")
    if not (isinstance(max_delay_ms, (int, float))
            and not isinstance(max_delay_ms, bool)
            and math.isfinite(max_delay_ms) and max_delay_ms > 0):
        raise ValueError(f"max_delay_ms must be a positive finite number, "
                         f"got {max_delay_ms!r}")
    _store(_deadline_key(op, n, dtype, backend),
           {"max_delay_ms": float(max_delay_ms), "measured": bool(measured)},
           "record:deadline", save)


# ---------------------------------------------------------------------------
# The Strassen route's fastmm namespace, the Markov route's markov namespace
# ---------------------------------------------------------------------------

def fastmm_config(dtype=None, backend: Optional[str] = None) -> tuple:
    """(crossover_n, max_levels, leaf_blocks) of the Strassen route.

    The ``fastmm`` entry for this dtype, then the dtype-agnostic one, then
    the defaults (``DEFAULT_FASTMM_CROSSOVER``, ``DEFAULT_FASTMM_LEVELS``,
    no leaf tiles). ``leaf_blocks`` is None unless an entry recorded a
    tiling, which is used only if K1 runs it for ``dtype``
    (``valid_blocks``): None lets every leaf pick its own tiles through
    ``ops.pick_blocks``. Consumers memoize the result per cache generation,
    so a retuned crossover reroutes a live engine.
    """
    for key in (_fastmm_key(dtype, backend), _fastmm_key(None, backend)):
        entry = _first([key], "fastmm")
        if entry is None:
            continue
        leaf = entry.get("leaf_blocks")
        if not _leaf_ok(leaf, dtype):
            continue
        return (int(entry["fastmm"][0]), int(entry["fastmm"][1]),
                None if leaf is None else tuple(int(x) for x in leaf))
    return DEFAULT_FASTMM_CROSSOVER, DEFAULT_FASTMM_LEVELS, None


def record_fastmm(crossover_n: int, max_levels: int, leaf_blocks=None,
                  dtype=None, backend: Optional[str] = None,
                  measured: bool = False, save: bool = True,
                  probes_us: Optional[dict] = None) -> None:
    """Store a Strassen config for one dtype and backend; ``measured``
    records whether a sweep on the card timed it, ``probes_us`` (the
    sweep's median times) is kept beside it. ``leaf_blocks`` must be a
    tiling K1 runs for ``dtype`` (float32 when None)."""
    if not _is_int(crossover_n) or crossover_n < 1:
        raise ValueError(f"fastmm crossover must be a positive int, "
                         f"got {crossover_n!r}")
    if not _is_int(max_levels) or max_levels < 0:
        raise ValueError(f"fastmm max_levels must be a non-negative int, "
                         f"got {max_levels!r}")
    if leaf_blocks is not None:
        leaf_blocks = [int(x) for x in leaf_blocks]
        if not _leaf_ok(leaf_blocks, dtype):
            raise ValueError(f"fastmm leaf_blocks must be three positive "
                             f"ints that K1 runs for {_dtype_key(dtype)} "
                             f"(valid_blocks), got {leaf_blocks!r}")
    entry = {"fastmm": [int(crossover_n), int(max_levels)],
             "leaf_blocks": leaf_blocks, "measured": bool(measured)}
    if probes_us is not None:
        entry["probes_us"] = dict(probes_us)
    _store(_fastmm_key(dtype, backend), entry, "record:fastmm", save)


def markov_evolve_threshold(dtype=None,
                            backend: Optional[str] = None) -> float:
    """The largest B/n ratio at which ``core.markov.evolve_distributions``
    evolves a (B, n) stack through its vector–matrix loop; above it, one
    dense power and one apply. The ``markov`` entry for this dtype, then
    the dtype-agnostic one, then ``DEFAULT_MARKOV_EVOLVE_THRESHOLD``."""
    entry = _first((_markov_key(dtype, backend), _markov_key(None, backend)),
                   "evolve_threshold")
    return float(entry["evolve_threshold"]) if entry else \
        DEFAULT_MARKOV_EVOLVE_THRESHOLD


def record_markov_evolve_threshold(threshold: float, dtype=None,
                                   backend: Optional[str] = None,
                                   measured: bool = False,
                                   save: bool = True) -> None:
    """Store an evolve-versus-dense B/n ratio (positive and finite)."""
    if not _positive_number(threshold):
        raise ValueError(f"markov evolve threshold must be a positive "
                         f"finite number, got {threshold!r}")
    _store(_markov_key(dtype, backend),
           {"evolve_threshold": float(threshold), "measured": bool(measured)},
           "record:markov", save)


# ---------------------------------------------------------------------------
# Scores: modeled and measured
# ---------------------------------------------------------------------------

def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def modeled_score(m: int, n: int, k: int, blocks: Sequence[int], dtype) -> float:
    """Analytic cost proxy of a matmul tiling (lower is better).

    Infinite for a tiling the kernels cannot run (``valid_blocks``);
    otherwise padding waste over the arithmetic intensity of one K step
    (FMAs per staged byte), divided by the share of the last wave of
    blocks that has work: a tile that leaves SMs idle scores worse.
    """
    bm, bn, bk = blocks
    itemsize = _itemsize(dtype)
    if not valid_blocks(blocks, itemsize):
        return float("inf")
    intensity = 2 * bm * bn * bk / ((bm + bn) * bk * itemsize)
    waste = (_round_up(m, bm) * _round_up(n, bn) * _round_up(k, bk)) \
        / (m * n * k)
    tiles = -(-m // bm) * -(-n // bn)
    fill = tiles / (-(-tiles // SM_COUNT) * SM_COUNT)
    return waste / (intensity * fill)


def modeled_attn_score(sq: int, skv: int, d: int, blocks: Sequence[int],
                       dtype) -> float:
    """Analytic cost proxy of a flash-attention ``(block_q, block_k)`` pair:
    infinite when the pair cannot run (``attn_blocks_usable``), otherwise
    the idle share of the tile that runs it over the arithmetic intensity
    of one KV step."""
    if not attn_blocks_usable(sq, skv, d, blocks, dtype):
        return float("inf")
    bq, bk = min(blocks[0], sq), min(blocks[1], skv)
    tq, tk = kernel_tile(bq, bk, d, dtype)
    width = head_dim_for(d)
    intensity = 4 * bq * bk * width / ((bq + 2 * bk) * width
                                       * _itemsize(dtype))
    return (tq * tk) / (bq * bk) / intensity


def device_times_us(fn, reps: int = 5) -> list:
    """Device time of one ``fn()`` in µs, ``reps`` samples.

    ``fn`` runs once untimed (the first launch builds the kernels' library),
    then is captured into a CUDA graph of back-to-back calls; each sample
    times one replay with two CUDA events and divides by the count, so the
    host's work per call (shape checks, the ctypes call, the allocator) is
    outside the measurement — at small shapes it is several times the
    kernel, and its jitter would rank kernels of a few microseconds. The run
    is sized from a first replay to last about 2 ms (1 to 50 calls). The L2
    is not flushed between calls: inside a chain the operand of every
    multiply was written by the one before.
    """
    fn()
    torch.cuda.synchronize()

    def capture(count):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(count):
                fn()
        return graph

    def sample_ms(graph, count):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / count

    one = capture(1)
    sample_ms(one, 1)
    count = max(1, min(50, int(2.0 / max(sample_ms(one, 1), 1e-3))))
    graph = capture(count) if count > 1 else one
    return [sample_ms(graph, count) * 1e3 for _ in range(reps)]


def _median_us(fn, reps: int) -> float:
    return float(np.median(device_times_us(fn, reps)))


def _randn(shape, dtype, device, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
        .to(device=device, dtype=dtype)


def measure_us(m: int, n: int, k: int, blocks: Sequence[int], dtype,
               reps: int = 3) -> float:
    """Median device time of K1 on the card for one tiling, operands padded
    to tile multiples; raises without a CUDA device."""
    from repro_torch import default_device
    from repro_torch.kernels.matmul import matmul_cuda
    bm, bn, bk = blocks
    device = default_device("cuda")
    a = _randn((_round_up(m, bm), _round_up(k, bk)), dtype, device, 0)
    b = _randn((_round_up(k, bk), _round_up(n, bn)), dtype, device, 1)
    return _median_us(lambda: matmul_cuda(a, b, block_m=bm, block_n=bn,
                                          block_k=bk), reps)


def measure_attn_us(sq: int, skv: int, d: int, blocks: Sequence[int], dtype,
                    reps: int = 3) -> float:
    """Median device time of K5 on the card for one ``(block_q, block_k)`` pair, causal, on
    a stack of ``ATTN_SWEEP_HEADS`` (Sq, D) slices in one launch. The cache
    key stays (sq, skv, d), as in the reference. Raises without a CUDA
    device, and ``ValueError`` for blocks the kernel does not take."""
    from repro_torch import default_device
    from repro_torch.kernels.attention import flash_attention
    bq, bk = blocks
    device = default_device("cuda")
    q = _randn((ATTN_SWEEP_HEADS, sq, d), dtype, device, 0)
    k = _randn((ATTN_SWEEP_HEADS, skv, d), dtype, device, 1)
    v = _randn((ATTN_SWEEP_HEADS, skv, d), dtype, device, 2)
    return _median_us(lambda: flash_attention(q, k, v, block_q=bq,
                                              block_k=bk), reps)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def _run_sweep(candidates, score_fn, fallback_fn, *, measure, record_fn,
               save: bool):
    """Shared sweep loop: score all candidates, pick/record the winner."""
    results = []
    for blocks in candidates:
        results.append({"blocks": blocks, "score": score_fn(blocks),
                        "measured": measure})
    results.sort(key=lambda r: r["score"])
    best = results[0]
    if not math.isfinite(best["score"]):
        best = {"blocks": fallback_fn(), "score": None, "measured": False}
    if save:
        record_fn(best)
    return tuple(best["blocks"]), results


def sweep(m: int, n: int, k: int, dtype=torch.float32,
          candidates: Optional[Iterable[Sequence[int]]] = None, *,
          backend: Optional[str] = None, measure: Optional[bool] = None,
          reps: int = 3, save: bool = True):
    """Score every candidate matmul tiling, record the winner under the
    ``matmul`` namespace, return ``(best, results)`` (results sorted
    best-first). The candidates default to the kernels' own:
    ``TC_CANDIDATES`` for 16-bit operands, ``DMMA_CANDIDATES`` for f64,
    ``DEFAULT_CANDIDATES`` else. ``measure=None`` measures on ``"cuda"``
    and models otherwise."""
    backend = _backend(backend)
    itemsize = _itemsize(dtype)
    default = {2: TC_CANDIDATES, 8: DMMA_CANDIDATES}.get(itemsize,
                                                          DEFAULT_CANDIDATES)
    candidates = [tuple(int(x) for x in c) for c in (candidates or default)]
    if measure is None:
        measure = backend == "cuda"

    def measured(b):
        if not valid_blocks(b, itemsize):
            return float("inf")
        return measure_us(m, n, k, b, dtype, reps=reps)

    return _run_sweep(
        candidates,
        measured if measure else (lambda b: modeled_score(m, n, k, b, dtype)),
        # No candidate can run: record the one staging the fewest operand
        # elements per K step (an uninstantiated pair has no footprint).
        lambda: min(candidates, key=lambda c: (c[0] + c[1]) * c[2]),
        measure=measure,
        record_fn=lambda best: record(
            m, n, k, best["blocks"], dtype=dtype, backend=backend,
            score=best["score"], measured=bool(measure and best["score"])),
        save=save)


def sweep_attention(sq: int, skv: int, d: int, dtype=torch.float32,
                    candidates: Optional[Iterable[Sequence[int]]] = None, *,
                    backend: Optional[str] = None,
                    measure: Optional[bool] = None,
                    reps: int = 3, save: bool = True):
    """Score every candidate ``(block_q, block_k)`` pair for an attention
    problem, record the winner under the ``attention`` namespace, return
    ``(best, results)`` — the flash-attention face of ``sweep``. A
    candidate the kernel rejects scores inf; the plain version is never
    measured in the kernel's place."""
    backend = _backend(backend)
    candidates = [tuple(int(x) for x in c)
                  for c in (candidates or attn_candidates(dtype))]
    if measure is None:
        measure = backend == "cuda"

    def measured(b):
        try:
            return measure_attn_us(sq, skv, d, b, dtype, reps=reps)
        except ValueError:
            return float("inf")

    return _run_sweep(
        candidates,
        measured if measure
        else (lambda b: modeled_attn_score(sq, skv, d, b, dtype)),
        lambda: min(candidates,
                    key=lambda c: c[0] * c[1]),
        measure=measure,
        record_fn=lambda best: record(
            sq, skv, d, best["blocks"], dtype=dtype, backend=backend,
            score=best["score"], measured=bool(measure and best["score"]),
            kernel="attention"),
        save=save)


def sweep_square_tiers(dtype=torch.float32, *, backend: Optional[str] = None,
                       measure: Optional[bool] = None,
                       save: bool = True) -> tuple:
    """Record the squaring tier limits for this dtype and backend.

    Measured (on ``"cuda"``): one probe per boundary. At p0, the largest
    power of two whose operand fits the whole-operand limit, K2 is timed
    against K3; if K3 wins, the limit drops below p0's operand. At p1, the
    largest power of two within the panel limit at which K3's row panel
    still fits shared memory, K3 is timed against K1; if K1 wins, the panel
    limit drops below p1's operand. Each side is ``TIER_PROBE_REPS`` device
    timings (``device_times_us``), and the challenger wins only if its
    slowest sample beats the default's fastest: a gap inside the
    run-to-run spread keeps the default. Tiles are those
    ``ops.pick_blocks`` gives p (the tuning cache's, where it has them).
    The entry keeps the probes' median µs. Modeled: the defaults are
    recorded as a ``measured: false`` entry, so the cache documents the
    policy in force.
    """
    backend = _backend(backend)
    if measure is None:
        measure = backend == "cuda"
    whole, panel = DEFAULT_SQUARE_TIERS
    probes = None
    if measure:
        from repro_torch import default_device
        from repro_torch.kernels import ops
        from repro_torch.kernels.matmul import square_cuda
        itemsize = _itemsize(dtype)
        device = default_device("cuda")
        probes = {}

        def blocks(p):
            bm, bn, bk = ops.pick_blocks(p, p, p, dtype=dtype, backend=backend)
            return dict(block_m=bm, block_n=bn, block_k=bk)

        def challenger_wins(p, default, challenger):
            """Time squarings of a (p, p) operand under two (smem_limit,
            panel_limit) pairs, named by the tier each sends p to."""
            a = _randn((p, p), dtype, device, 0) * p ** -0.5
            kw = blocks(p)
            times = {}
            for tier, (smem_limit, panel_limit) in (default, challenger):
                times[tier] = device_times_us(
                    lambda: square_cuda(a, smem_limit=smem_limit,
                                        panel_limit=panel_limit, **kw),
                    TIER_PROBE_REPS)
                probes[f"{p}:{tier}"] = float(np.median(times[tier]))
            (_, base), (_, alt) = times.items()
            return max(alt) < min(base)

        def largest_pow2(limit_bytes):
            return 1 << int(math.log2(math.isqrt(limit_bytes // itemsize)))

        p0 = largest_pow2(whole)
        if challenger_wins(p0, ("whole", (whole, panel)),
                           ("panel", (0, panel))):
            whole = p0 * p0 * itemsize - 1        # K3 wins: shrink the tier
        p1 = largest_pow2(panel)
        while p1 > p0:
            kw = blocks(p1)
            if panel_smem_footprint(p1, kw["block_m"], kw["block_n"],
                                    itemsize, kw["block_k"]) <= SMEM_PER_BLOCK:
                break
            p1 //= 2
        if p1 > p0 and challenger_wins(p1, ("panel", (0, panel)),
                                       ("matmul", (0, 0))):
            panel = p1 * p1 * itemsize - 1        # K1 wins: shrink the tier
        panel = max(panel, whole)
    if save:
        record_square_tiers(whole, panel, dtype=dtype, backend=backend,
                            measured=bool(measure), probes_us=probes)
    return whole, panel


def sweep_fastmm(dtype=torch.float32, *, backend: Optional[str] = None,
                 measure: Optional[bool] = None,
                 candidates: Sequence[int] = (256, 512, 1024),
                 reps: int = 3, save: bool = True) -> tuple:
    """Record the Strassen crossover for this dtype and backend; returns
    ``(crossover_n, max_levels)``.

    Measured (``measure=None`` measures on ``"cuda"``): each candidate c is
    probed at n = 2c, the smallest size that recurses exactly one level:
    the dense squaring (``ops.square``) against one Strassen level
    (``fastmm.strassen_square(levels=1, crossover=c)``), each the median of
    ``reps`` device timings (``device_times_us``); the smallest candidate
    at which Strassen wins is recorded, ``DEFAULT_FASTMM_CROSSOVER`` when
    none does. The probes' median µs are kept in the entry. Modeled: the
    defaults are recorded as a ``measured: false`` entry, so the cache
    documents the policy in force.
    """
    backend = _backend(backend)
    if measure is None:
        measure = backend == "cuda"
    crossover, levels = DEFAULT_FASTMM_CROSSOVER, DEFAULT_FASTMM_LEVELS
    probes = None
    if measure:
        from repro_torch import default_device
        from repro_torch.kernels import fastmm, ops
        device = default_device("cuda")
        probes = {}
        for cand in sorted(int(c) for c in candidates):
            n = 2 * cand
            a = _randn((n, n), dtype, device, 0) * n ** -0.25
            dense_us = _median_us(lambda: ops.square(a), reps)
            fast_us = _median_us(
                lambda c=cand: fastmm.strassen_square(a, levels=1,
                                                      crossover=c), reps)
            probes[f"{n}:dense"] = dense_us
            probes[f"{n}:strassen"] = fast_us
            if fast_us < dense_us:
                crossover = cand
                break
    if save:
        record_fastmm(crossover, levels, dtype=dtype, backend=backend,
                      measured=bool(measure), probes_us=probes)
    return crossover, levels
