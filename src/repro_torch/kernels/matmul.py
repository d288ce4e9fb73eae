"""Tiled matmul and the tiered squaring kernels — wrappers, plain versions,
tier policy and launch counters.

The port of the reference's ``repro/kernels/matmul.py``. Hand-written CUDA
kernels stand where its three Pallas kernels stood:

  ``matmul_cuda``            K1, replaces ``matmul_pallas`` / ``matmul_kernel``
  ``square_cuda`` "whole"    K2, replaces ``square_pallas`` / ``square_kernel``
  ``square_cuda`` "panel"    K3, replaces ``square_pallas`` /
                             ``square_panel_kernel``

For f32 all three are the FMA kernels of ``csrc/gemm.cuh`` (K1 and K3 fed by
a ``cp.async`` ring whose K step and stages are compile-time: K1 takes only
the ``F32_BLOCKS`` pairs, K3 picks its own panel height and grid,
``square_panel_grid``; K2 stages the boxes of A its tiles read and splits
K into slices, on a tile and grid of its own). For bf16 and
f16 all three are the tensor-core kernels of ``csrc/gemm_tc.cuh`` (K1 and K3
``wgmma`` fed by a TMA ring, ``mma.sync`` at tile 32; K2 ``mma.sync`` on A
staged by TMA), counted under ``matmul_tc`` / ``square_whole_tc`` /
``square_panel_tc``. For f64 all three are the fp64 tensor-core (DMMA)
kernels of ``csrc/gemm_dmma.cuh``, counted under ``matmul_dmma`` /
``square_whole_dmma`` / ``square_panel_dmma``; K2 and K3 pick their own
tiles and grids there too. The stacked
``(B, ., .)`` form of each is the same kernel with the stack on a grid axis
— one launch for the stack (the reference's ``jax.vmap``).

K1 and K3 are bound by operations, not bytes, at the sizes the chain uses,
and K2 by latency and the grid; the ``.cuh`` files say what each design does
about it. What each squaring tier keeps out of device memory: "whole" stages
what a block's tiles read of A once per block (its tiles' boxes of it on
the tensor cores, their rows and columns in f32) and takes both panels of
every output tile from that copy (no second read of A);
"panel" stages a row panel once per block and loops over the column tiles
inside the block (no re-read of the row panel per output tile).

Each wrapper computes on the device its operand lies on: a CUDA tensor goes
to the kernel (or raises — nothing falls back when a build or a launch
fails), a CPU tensor goes to the plain PyTorch version beside it
(``matmul_plain`` / ``square_plain``), which runs the same checks and the
same tier selection. ``LAUNCHES`` counts both routes so a run can show which
way it went, and ``last_launch`` records the kernel, output tile and grid of
the last call on either route.

Shapes must be block-divisible here — ``ops.matmul`` / ``ops.square`` / the
chain executors pad arbitrary shapes.
"""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch import accum_dtype, dtype_name, is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

__all__ = ["matmul_cuda", "matmul_plain", "square_cuda", "square_plain",
           "square_tier", "square_whole_grid", "square_panel_grid",
           "panel_width", "panel_smem_footprint", "smem_footprint",
           "fma_smem_bytes", "fma_panel_smem_bytes", "tc_smem_bytes",
           "dmma_smem_bytes", "whole_tc_smem_bytes", "whole_dmma_smem_bytes",
           "dmma_panel_smem_bytes", "dmma_panel_ring", "whole_fma_smem_bytes",
           "whole_smem_bytes", "kernel_name",
           "DEFAULT_BLOCK", "KERNEL_TILES", "SMEM_PER_BLOCK", "SMEM_PER_SM",
           "L2_BYTES", "SM_COUNT", "F32_BLOCKS", "F32_STAGES", "FMA_PANELS",
           "FMA_PANEL_BK", "FMA_PANEL_STAGES", "TC_BLOCKS", "TC_DEFAULT_BK",
           "DMMA_BLOCKS", "DMMA_STAGES", "DMMA_TILES", "DMMA_PANELS",
           "DMMA_PANEL_RINGS",
           "WHOLE_TC_TILES", "WHOLE_DMMA_TILES", "WHOLE_F32", "KERNELS",
           "SQUARE_SMEM_LIMIT", "SQUARE_PANEL_LIMIT", "LAUNCHES",
           "last_launch", "last_launch_snapshot", "reset_launches",
           "launch_counts"]

#: Dynamic shared memory one block may use on Hopper (227 KB, opt-in).
SMEM_PER_BLOCK = 232_448
#: Shared memory of one SM (228 KB), and what the card keeps of it for each
#: resident block: how many blocks of a footprint an SM holds at once.
SMEM_PER_SM = 233_472
SMEM_PER_RESIDENT_BLOCK = 1024
#: Threads one SM holds at once, and the threads of a block of the FMA K3.
THREADS_PER_SM = 2048
FMA_THREADS = 256
#: L2 cache of the H100.
L2_BYTES = 50_000_000
#: Streaming multiprocessors of the H100 (and H200): how many blocks it
#: takes to give every SM one.
SM_COUNT = 132
#: Shared-memory row padding of K1's A tiles and K3's row panel, in
#: elements (``kPad`` of gemm.cuh).
SMEM_PAD = 4
#: Square output tiles the kernels are instantiated for.
KERNEL_TILES = (32, 64, 128)
#: Output tiles the f32 FMA K2 is instantiated for, each with its thread
#: tile (R rows x C columns) and K slices (the ``REPRO_WHOLE_F32`` lines of
#: csrc/gemm.cuh; ``whole_fma_smem_bytes``).
WHOLE_F32 = {16: (4, 8, 16), 32: (8, 4, 4), 64: (8, 8, 4)}
#: Tiles a side of an f32 K2 operand at most (a block's tile rows and
#: columns are one 32-bit mask each).
WHOLE_F32_MAX_PER_ROW = 32
#: (tile, K step) pairs the f32 FMA K1 is instantiated for, and the ring
#: stages of each (the ``REPRO_F32_TILE`` lines of csrc/gemm.cuh;
#: ``fma_smem_bytes``): at ``WIDE_TILE`` the stages of the wide kernel's B
#: ring, whose A goes through two buffers of its own.
F32_STAGES = {(32, 16): 4, (32, 32): 3, (64, 16): 4, (64, 32): 2,
              (128, 16): 4, (128, 32): 4}
F32_BLOCKS = tuple(F32_STAGES)
#: The f32 K1's tile on the wide kernel (``kWideTile`` of csrc/gemm.cuh,
#: ``matmul_wide_kernel``): 16 x 8 outputs a thread over A staged k-major.
WIDE_TILE = 128
#: (panel height, column width) pairs the f32 FMA K3 is instantiated
#: for (the ``REPRO_FMA_PANEL`` lines of csrc/gemm.cuh), and the K step and
#: stages of the ring its column tiles stream through (``kPanelBK``,
#: ``kPanelStages``; ``fma_panel_smem_bytes``).
FMA_PANELS = ((32, 32), (32, 64), (64, 64))
FMA_PANEL_BK = 32
FMA_PANEL_STAGES = 3
#: (tile, K step) pairs the 16-bit tensor-core K1 / K3 are instantiated for
#: (the ``REPRO_TC_TILE`` lines of csrc/gemm_tc.cuh): tile 32 on
#: ``mma.sync``, 64 and 128 on ``wgmma``, whose K step is 32 or 64.
TC_BLOCKS = ((32, 32), (64, 32), (64, 64), (128, 32), (128, 64))
#: K step ``ops.pick_blocks`` starts from for 16-bit operands (at most the
#: tile).
TC_DEFAULT_BK = 64
# The constants of gemm_tc.cuh that its shared-memory formulas use
# (``tc_smem_bytes``): swizzled tiles start 1024-aligned (the launchers ask
# for 1024 bytes of slack), a K1 ring takes at most half a block's shared
# memory (two blocks per SM), K3 streams its column tiles through 4 stages,
# the tile-32 buffers pad each row by 8 elements, and an mbarrier is 8
# bytes.
TC_ALIGN = 1024
TC_RING_BUDGET = SMEM_PER_BLOCK // 2
TC_PANEL_STAGES = 4
TC_MMA_PAD = 8
TC_BARRIER = 8
#: Output tiles the 16-bit tensor-core K2 is instantiated for (the
#: ``REPRO_WHOLE_TC`` lines of csrc/gemm_tc.cuh), and the side of the square
#: TMA boxes it stages A in.
WHOLE_TC_TILES = (32, 64)
WHOLE_TC_BOX = 64
WHOLE_TC_RED = 4 * 32 * 32 * 4
#: (tile, K step) pairs the fp64 tensor-core K1 is instantiated for, and the
#: ring stages of each (the ``REPRO_DMMA_TILE`` lines of csrc/gemm_dmma.cuh);
#: the staged rows are padded by ``DMMA_PAD`` doubles (``dmma_smem_bytes``).
DMMA_STAGES = {(32, 16): 4, (64, 16): 4, (64, 32): 2}
DMMA_BLOCKS = tuple(DMMA_STAGES)
#: The output tiles among them, smallest first.
DMMA_TILES = tuple(sorted({t for t, _ in DMMA_BLOCKS}))
DMMA_PAD = 4
#: Output tiles the fp64 K2 is instantiated for (the ``REPRO_WHOLE_DMMA``
#: lines of csrc/gemm_dmma.cuh), the side of the boxes it stages A in
#: (``kBox``) and the bytes it keeps for the K slices' partial sums
#: (``kWholeRed``; ``whole_dmma_smem_bytes``).
WHOLE_DMMA_TILES = (16, 32, 64)
DMMA_BOX = 16
WHOLE_DMMA_RED = 32 * (32 + DMMA_PAD) * 8
#: (panel height, column width, K step) rings the fp64 K3 is instantiated
#: for, and the stages of each (the ``REPRO_DMMA_PANEL`` lines of
#: csrc/gemm_dmma.cuh; ``dmma_panel_ring``, ``dmma_panel_smem_bytes``), and
#: the (height, width) pairs among them: one width per height.
DMMA_PANEL_RINGS = {(16, 32, 64): 3, (16, 32, 32): 4, (32, 32, 64): 2,
                    (32, 32, 32): 3, (64, 64, 16): 3}
DMMA_PANELS = tuple(sorted({(h, w) for h, w, _ in DMMA_PANEL_RINGS}))
#: Warps of a K2 / K3 block of gemm_dmma.cuh (``kSquareWarps``).
DMMA_SQUARE_WARPS = 4
#: The fp64 K2 / K3 grid rules' model of a block on its SM (``_dmma_cost``),
#: fitted to ``tools/sweep_dmma_squares.py``'s timings of K3 grids on an
#: NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6): each K step a block
#: waits through costs ``DMMA_STEP_NS``, each byte it copies from L2 into
#: shared memory 1 / ``DMMA_BLOCK_GBPS`` ns (blocks resident on one SM copy
#: side by side), and each flop 1 / ``DMMA_SM_GFLOPS`` ns of its SM's fp64
#: tensor cores, which those blocks share.
DMMA_STEP_NS = 330
DMMA_BLOCK_GBPS = 71
DMMA_SM_GFLOPS = 400
#: The f32 K2 grid rule's model of a block on its SM (``_fma_whole_grid``):
#: each block costs ``FMA_WHOLE_BLOCK_NS`` (its wait and barriers), each
#: byte it copies from L2 1 / ``FMA_WHOLE_BLOCK_GBPS`` ns (both the fp64
#: rule's fit), and each flop 1 / ``FMA_SM_GFLOPS`` ns of its SM's FMA
#: pipeline (67 TFLOP/s over 132 SMs) divided by the share of that rate its
#: thread tile can feed from shared memory (``_fma_feed``). At each operand
#: ``tools/sweep_fma_k2_k5.py`` times (128², 192², 224², 32 x 128²) the grid
#: it picks was the fastest of those timed (PERF.md §6).
FMA_WHOLE_BLOCK_NS = 330
FMA_WHOLE_BLOCK_GBPS = 71
FMA_SM_GFLOPS = 507

# Default tile: 128 x 128 output tile per 128-thread block (f32: the wide
# kernel, a 16 x 8 register micro-tile per thread, 128 FMAs for six 16-byte
# shared loads a k), K step 32: at f32 two 16.5 KB A buffers and a B ring of
# 4 stages of 16 KB, 97 KB, so two blocks share an SM.
# ``ops.pick_blocks`` drops to 64 / 32 tiles for problems too small to fill
# the SMs with 128s.
DEFAULT_BLOCK = (128, 128, 32)

# "whole" tier: the operand (in its storage dtype) fits the per-block shared
# memory: P <= 224 at 4 bytes, P <= 320 at 2 bytes for tile-divisible P.
# Each K2 block stages what its tiles read of it (the f32 K2 their rows and
# columns only, in strips far smaller than the operand).
SQUARE_SMEM_LIMIT = SMEM_PER_BLOCK

# "panel" tier: every block row streams the whole column panel again, so the
# tier pays off only while those re-reads hit L2. Operand and result both
# resident in the 50 MB L2 -> operand <= 25 MB. (Whether the (block_m, P)
# row panel also fits shared memory depends on the tile and is decided per
# call by ``panel_smem_footprint``; when it does not, the call is demoted to
# the two-operand kernel.)
SQUARE_PANEL_LIMIT = L2_BYTES // 2

#: The kernels, by the name their launches are counted under.
KERNELS = ("matmul", "matmul_tc", "matmul_dmma", "square_whole",
           "square_whole_tc", "square_whole_dmma", "square_panel",
           "square_panel_tc", "square_panel_dmma")

#: Launches per kernel since the last ``reset_launches()``. The kernel
#: wrappers add one where they launch (``KERNELS``: the ``_tc`` names are
#: the 16-bit tensor-core K1–K3, the ``_dmma`` names the fp64 tensor-core
#: K1–K3); the plain versions add one under ``plain_<name>``.
LAUNCHES = {**{name: 0 for name in KERNELS},
            "plain_matmul": 0, "plain_square_whole": 0,
            "plain_square_panel": 0}

#: The last call's kernel (its ``KERNELS`` name, or ``plain_<name>``),
#: output ``tile``, ``blocks`` in its grid, and for the squaring kernels the
#: ``groups`` of blocks that share each matrix. While other threads launch,
#: read it through ``last_launch_snapshot()``.
last_launch: dict = {}

# Guards LAUNCHES and last_launch: the serving engine's stream workers
# launch from several threads at once.
_COUNT_LOCK = threading.Lock()


def kernel_name(op: str, dtype) -> str:
    """The counter of ``KERNELS`` that a launch of ``op`` — ``"matmul"``
    (K1), ``"square_whole"`` (K2) or ``"square_panel"`` (K3) — on ``dtype``
    operands goes to: bf16 / f16 run the tensor-core kernels (``_tc``), f64
    the fp64 tensor-core kernels (``_dmma``), f32 the FMA kernels."""
    if op not in ("matmul", "square_whole", "square_panel"):
        raise ValueError(f"no kernel for op {op!r}")
    if dtype in (torch.float16, torch.bfloat16):
        return op + "_tc"
    if dtype == torch.float64:
        return op + "_dmma"
    return op


def _record(kernel, tile, blocks, **extra) -> None:
    """Count one launch of ``kernel`` and make it ``last_launch``, under one
    lock."""
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
        last_launch.clear()
        last_launch.update(kernel=kernel, tile=tile, blocks=blocks, **extra)


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


# ---------------------------------------------------------------------------
# Footprints and the tier policy
# ---------------------------------------------------------------------------

def tc_smem_bytes(tile: int, block_k: int, p: int | None = None) -> int:
    """Dynamic shared-memory bytes a 16-bit launcher of gemm_tc.cuh asks
    for at a square ``tile`` and K step ``block_k``: K1's, or K3's over a
    ``(p, p)`` operand. The ``Ring`` / ``PanelRing`` / ``MmaTiles`` formulas
    of the ``.cuh`` (a test evaluates them against this one):

    tile 32 (``mma.sync``): two ``cp.async`` buffers of B tiles, padded, and
    for K1 two of A, for K3 the resident row panel, padded. Above it
    (``wgmma``): K1 a ring of 4 stages of A and B boxes, 3 where 4 would
    take more than ``TC_RING_BUDGET``; K3 the row panel and
    ``TC_PANEL_STAGES`` stages of B boxes and one barrier for the panel.
    Every ring stage carries a full and an empty barrier, and every ring
    the alignment slack."""
    b_pitch = tile + TC_MMA_PAD
    if tile == 32:
        if p is None:
            return 2 * (tile * (block_k + TC_MMA_PAD) + block_k * b_pitch) * 2
        return tile * (p + TC_MMA_PAD) * 2 + 2 * block_k * b_pitch * 2
    barriers = 2 * TC_BARRIER
    if p is None:
        stage = 2 * tile * block_k * 2 + barriers
        stages = 4 if TC_ALIGN + 4 * stage <= TC_RING_BUDGET else 3
        return TC_ALIGN + stages * stage
    return (TC_ALIGN + tile * p * 2
            + TC_PANEL_STAGES * (block_k * tile * 2 + barriers) + TC_BARRIER)


def dmma_smem_bytes(tile: int, block_k: int) -> int:
    """Dynamic shared-memory bytes the fp64 tensor-core K1 asks for at a
    square ``tile`` and K step ``block_k``: the ``DmmaRing`` formula of
    csrc/gemm_dmma.cuh (a test evaluates it against this one). Each of the
    pair's ``DMMA_STAGES`` stages holds the [tile x K step] A tile and the
    [K step x tile] B tile in doubles, rows padded by ``DMMA_PAD``. A pair
    that is not instantiated raises ``KeyError``."""
    stage = (tile * (block_k + DMMA_PAD) + block_k * (tile + DMMA_PAD)) * 8
    return DMMA_STAGES[(tile, block_k)] * stage


def whole_tc_smem_bytes(p: int) -> int:
    """Dynamic shared-memory bytes the 16-bit tensor-core K2 asks for over a
    ``(p, p)`` operand: the ``WholeBoxes`` formula of csrc/gemm_tc.cuh — A
    in ``WHOLE_TC_BOX``-square boxes (zero past p), a barrier each, the
    partial sums of tile 32's four warps (``WHOLE_TC_RED``) and the
    alignment slack."""
    boxes = (-(-p // WHOLE_TC_BOX)) ** 2
    return TC_ALIGN + WHOLE_TC_RED + boxes * (
        WHOLE_TC_BOX * WHOLE_TC_BOX * 2 + TC_BARRIER)


def whole_dmma_smem_bytes(p: int) -> int:
    """Dynamic shared-memory bytes the fp64 K2 asks for over a ``(p, p)``
    operand: the ``DmmaWhole`` formula of csrc/gemm_dmma.cuh (a test
    evaluates it against this one) — the image of A, rows padded by
    ``DMMA_PAD``, and ``WHOLE_DMMA_RED`` for the partial sums of every
    instantiated tile."""
    return p * (p + DMMA_PAD) * 8 + WHOLE_DMMA_RED


@functools.lru_cache(maxsize=None)
def whole_strips(per_row: int, groups: int) -> tuple:
    """(tile rows, tile columns): the most that one block of a K2 grid of
    ``groups`` blocks a matrix owns, block b taking tiles b, b + groups, ...
    of ``per_row``² (``whole_strips`` of csrc/gemm.cuh). Memoised: a
    launch checks its footprint on every call."""
    n = per_row * per_row
    nr = nc = 0
    for b in range(min(groups, n)):
        mine = range(b, n, groups)
        nr = max(nr, len({t // per_row for t in mine}))
        nc = max(nc, len({t % per_row for t in mine}))
    return nr, nc


def whole_fma_smem_bytes(p: int, tile: int, groups: int) -> int:
    """Dynamic shared-memory bytes the f32 K2 asks for over a ``(p, p)``
    operand on output tiles of ``tile``, ``groups`` blocks a matrix: the
    ``WholeFma`` formula of csrc/gemm.cuh (a test evaluates it against this
    one) — the row strip of the block's tile rows and the column strip of
    its tile columns (``whole_strips``), rows padded by ``SMEM_PAD``, and
    the partial sums of the tile's K slices. A tile that is not
    instantiated raises ``KeyError``."""
    nr, nc = whole_strips(p // tile, groups)
    return ((nr * tile * (p + SMEM_PAD) + p * (nc * tile + SMEM_PAD)) * 4
            + WHOLE_F32[tile][2] * tile * tile * 4)


def _fma_feed(rows: int, cols: int) -> float:
    """Share of the FMA rate an R x C thread tile keeps fed: it reads R + C
    16-byte words from shared memory per 4 R C FMAs, and a word costs the
    SM four of the cycles in which it issues 16 warp FMAs (the rates
    PERF.md §6 records for the FMA kernels), so the pipe is fed where
    4 R C >= 16 (R + C)."""
    return min(1.0, rows * cols / (4 * (rows + cols)))


def dmma_slices(tm: int, tn: int) -> int:
    """K slices of an fp64 K2 / K3 block over a ``tm`` x ``tn`` output tile
    (``SquareWarps::KS`` of csrc/gemm_dmma.cuh): the block's warps that the
    output's warp tiles, 16 (32 at 64 rows) by at most 32, leave over."""
    wm = 16 if tm < 64 else 32
    return DMMA_SQUARE_WARPS // (tm // wm * (tn // min(tn, 32)))


def dmma_panel_ring(p: int, height: int) -> tuple:
    """(width, K step, stages) of the fp64 K3's launch over a ``(p, p)``
    operand with a panel of ``height`` rows: the ``DMMA_PANEL_RINGS`` entry
    of that height with the deepest K step that divides ``p`` (the
    shallowest where none does: such a ``p`` is not a multiple of the
    chain's tile, and ``square_cuda`` refuses it). A height without a pair
    raises ``KeyError``."""
    rings = sorted(((p % bk == 0, bk, w, st)
                    for (h, w, bk), st in DMMA_PANEL_RINGS.items()
                    if h == height), reverse=True)
    if not rings:
        raise KeyError(f"no fp64 K3 ring of height {height}: "
                       f"{DMMA_PANEL_RINGS}")
    _, block_k, width, stages = rings[0] if rings[0][0] else rings[-1]
    return width, block_k, stages


def dmma_panel_smem_bytes(p: int, height: int) -> int:
    """Dynamic shared-memory bytes the fp64 K3 asks for over a ``(p, p)``
    operand with a panel of ``height`` rows: the ``DmmaPanel`` formula of
    csrc/gemm_dmma.cuh (a test evaluates it against this one) at
    ``dmma_panel_ring``'s ring — the row panel, rows padded by
    ``DMMA_PAD``; the ring's stages of [K step x width] column tiles,
    padded alike; and the partial sums of its K slices past the first."""
    width, block_k, stages = dmma_panel_ring(p, height)
    red = (dmma_slices(height, width) - 1) * height * (width + DMMA_PAD) * 8
    return (height * (p + DMMA_PAD) * 8
            + stages * block_k * (width + DMMA_PAD) * 8 + red)


def fma_smem_bytes(tile: int, block_k: int) -> int:
    """Dynamic shared-memory bytes the f32 FMA K1 asks for at a square
    ``tile`` and K step ``block_k`` (a test evaluates the formulas of
    csrc/gemm.cuh against these). At ``WIDE_TILE`` the ``WideRing``
    formula: two k-major [K step x tile] A buffers, rows padded by
    ``SMEM_PAD``, and the pair's ``F32_STAGES`` stages of the [K step x
    tile] B tile. Below it the ``FmaRing`` formula: ``F32_STAGES`` stages,
    each the [tile x K step] A tile, rows padded by ``SMEM_PAD``, and the
    [K step x tile] B tile. A pair that is not instantiated raises
    ``KeyError``."""
    stages = F32_STAGES[(tile, block_k)]
    b_stage = block_k * tile * 4
    if tile == WIDE_TILE:
        return 2 * block_k * (tile + SMEM_PAD) * 4 + stages * b_stage
    return stages * (tile * (block_k + SMEM_PAD) * 4 + b_stage)


def panel_width(p: int) -> int:
    """Column width of the FMA K3's output tiles over a ``(p, p)`` operand:
    64 where it divides ``p``, else 32."""
    return 64 if p % 64 == 0 else 32


def fma_panel_smem_bytes(p: int, height: int) -> int:
    """Dynamic shared-memory bytes the f32 FMA K3 asks for over a ``(p, p)``
    operand with a panel of ``height`` rows: the ``FmaPanel`` formula of
    csrc/gemm.cuh — the row panel, rows padded by ``SMEM_PAD``;
    ``FMA_PANEL_STAGES`` stages of [``FMA_PANEL_BK`` x ``panel_width(p)``]
    column tiles; and the partial sums of the block's K slices past the
    first (its ``FMA_THREADS`` are slices of ``2 * height`` threads, each
    over the whole output tile)."""
    width = panel_width(p)
    slices = FMA_THREADS // (2 * height)
    return (height * (p + SMEM_PAD) * 4
            + FMA_PANEL_STAGES * FMA_PANEL_BK * width * 4
            + (slices - 1) * height * width * 4)


def smem_footprint(blocks, itemsize: int = 4) -> int:
    """Dynamic shared-memory bytes one K1 block asks for: for f32
    ``fma_smem_bytes``, for 16-bit ``tc_smem_bytes``, for f64
    ``dmma_smem_bytes``. An f32 or f64 pair its kernel does not instantiate
    raises ``KeyError``."""
    bm, bn, bk = blocks
    if itemsize == 2:
        return tc_smem_bytes(bm, bk)
    if itemsize == 8:
        return dmma_smem_bytes(bm, bk)
    return fma_smem_bytes(bm, bk)


def panel_smem_footprint(p: int, block_m: int, block_n: int,
                         itemsize: int = 4,
                         block_k: int = DEFAULT_BLOCK[2]) -> int:
    """Dynamic shared-memory bytes of a panel-tier block whose row panel is
    ``block_m`` rows: for 16-bit ``tc_smem_bytes`` (the chain's tile and K
    step), for f32 ``fma_panel_smem_bytes``, for f64
    ``dmma_panel_smem_bytes`` at the tallest ``DMMA_PANELS`` height no
    taller than ``block_m`` (each on its own ring; ``block_n`` and
    ``block_k`` do not enter). The panel tier is usable only when this fits
    ``SMEM_PER_BLOCK`` at the chain's tile — ``square_cuda`` demotes to the
    two-operand kernel otherwise."""
    if itemsize == 2:
        return tc_smem_bytes(block_m, block_k, p)
    if itemsize == 8:
        return dmma_panel_smem_bytes(p, _dmma_panel_height(block_m))
    return fma_panel_smem_bytes(p, block_m)


def _dmma_panel_height(block_m: int) -> int:
    """The tallest fp64 K3 panel height no taller than ``block_m`` (the
    shortest where none is)."""
    heights = sorted(h for h, _ in DMMA_PANELS)
    return max((h for h in heights if h <= block_m), default=heights[0])


def square_tier(operand_bytes: int, smem_limit: int = SQUARE_SMEM_LIMIT,
                panel_limit: int = SQUARE_PANEL_LIMIT) -> str:
    """Memory-tier policy for C = A @ A: which kernel serves this operand.

    ``"whole"``       — A fits ``smem_limit``: every block stages the entire
                        operand once for both sides of the product (K2).
    ``"panel"``       — A fits ``panel_limit``: a row panel is staged once
                        per block, the column panel streams through L2 (K3).
    ``"two_operand"`` — tiles of A stream twice through the matmul kernel
                        (K1).

    Boundaries are inclusive: an operand exactly at a limit takes the more
    resident tier.
    """
    if operand_bytes <= smem_limit:
        return "whole"
    if operand_bytes <= panel_limit:
        return "panel"
    return "two_operand"


def _resolve_tier(p, itemsize, block_m, block_n, block_k, smem_limit,
                  panel_limit) -> str:
    tier = square_tier(p * p * itemsize, smem_limit, panel_limit)
    if tier == "panel" and panel_smem_footprint(
            p, block_m, block_n, itemsize, block_k) > SMEM_PER_BLOCK:
        # The operand qualifies by size but these tiles make the row panel
        # itself bust shared memory — stream through the two-operand kernel.
        tier = "two_operand"
    return tier


# ---------------------------------------------------------------------------
# Shape contracts (shared by the kernel route and the plain route)
# ---------------------------------------------------------------------------

def _check_matmul(a, b, block_m, block_n, block_k):
    """Validate ``a @ b``; returns (batch or None, m, k, n)."""
    if (a.ndim not in (2, 3) or b.ndim not in (2, 3)
            or a.shape[-1] != b.shape[-2]
            or (a.ndim == 3 and b.ndim == 3 and a.shape[0] != b.shape[0])):
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"matmul operands differ in dtype or device: "
                         f"{a.dtype}@{a.device} vs {b.dtype}@{b.device}")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shapes ({m},{k})x({k},{n}) not divisible by blocks "
            f"({block_m},{block_n},{block_k}); use ops.matmul")
    batch = a.shape[0] if a.ndim == 3 else (b.shape[0] if b.ndim == 3
                                            else None)
    return batch, m, k, n


def _check_square(a):
    """Validate the operand of ``a @ a``; returns (batch or None, p)."""
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"square_cuda needs a square 2-D matrix (or a "
                         f"stack of them), got {tuple(a.shape)}")
    return (a.shape[0] if a.ndim == 3 else None), a.shape[-1]


def _check_square_blocks(p, block_m, block_n):
    if p % block_m or p % block_n:
        raise ValueError(
            f"shape ({p},{p}) not divisible by blocks ({block_m},{block_n}); "
            "use ops.MatmulChain / ops.matmul for arbitrary shapes")


def _deliver(result, out):
    if out is None:
        return result
    if out.shape != result.shape or out.device != result.device:
        raise ValueError(f"out has shape {tuple(out.shape)} on {out.device}, "
                         f"expected {tuple(result.shape)} on {result.device}")
    out.copy_(result)
    return out


# ---------------------------------------------------------------------------
# Kernel-route hygiene
# ---------------------------------------------------------------------------

def _groups(shared_tiles: int, independent_blocks: int) -> int:
    """Blocks that share one staged operand (K2) or row panel (K3): as few
    as fill the SMs, at most one per output tile they share."""
    want = -(-SM_COUNT // max(independent_blocks, 1))
    return max(1, min(shared_tiles, want))


def square_whole_grid(p: int, batch: int, dtype) -> tuple:
    """(output tile, groups) of a whole-operand squaring (K2) of a ``(p, p)``
    operand, or a stack of ``batch`` of them, chosen by K2 itself whatever
    the chain's tile. f64 (the DMMA K2): ``_dmma_whole_grid``; f32 (the FMA
    K2): ``_fma_whole_grid``. bf16 / f16: for each of ``WHOLE_TC_TILES``
    that divides ``p``, ``_groups`` blocks share each matrix's tiles; the
    tile taken is the one whose busiest SM has the least output to compute
    — waves of ``SM_COUNT`` blocks times the tiles of a block times a
    tile's area — the larger on a tie (fewer, larger tiles stage A fewer
    times and keep more of each block's math in registers). So 192² takes
    32-wide tiles (36 blocks instead of 9), and a stack of 32 of 128²
    64-wide ones (128 blocks of one tile, not 160 of four). ``p`` is a
    multiple of the chain's tile, so of 32."""
    if dtype == torch.float64:
        return _dmma_whole_grid(p, batch)
    if dtype == torch.float32:
        return _fma_whole_grid(p, batch)
    tiles = WHOLE_TC_TILES
    best = None
    for tile in sorted((t for t in tiles if p % t == 0), reverse=True):
        count = (p // tile) ** 2
        groups = _groups(count, batch)
        waves = -(-groups * batch // SM_COUNT)
        load = waves * -(-count // groups) * tile * tile
        if best is None or load < best[0]:
            best = (load, tile, groups)
    if best is None:
        raise ValueError(f"no whole-operand tile of {tiles} divides {p}")
    return best[1], best[2]


def _dmma_cost(blocks: int, footprint: int, steps: int, staged: int,
               flops: int) -> float:
    """Modelled ns of the busiest SM for a grid of ``blocks`` fp64 K2 / K3
    blocks of ``footprint`` bytes of shared memory, each waiting through
    ``steps`` K steps, copying ``staged`` bytes from L2 and computing
    ``flops`` (``DMMA_STEP_NS``, ``DMMA_BLOCK_GBPS``, ``DMMA_SM_GFLOPS``): an
    SM runs ceil(blocks / ``SM_COUNT``) of them, as many at once as its
    shared memory holds."""
    per_sm = -(-blocks // SM_COUNT)
    resident = max(1, min(SMEM_PER_SM // (footprint + SMEM_PER_RESIDENT_BLOCK),
                          THREADS_PER_SM // (32 * DMMA_SQUARE_WARPS)))
    waves = -(-per_sm // resident)
    return (waves * (steps * DMMA_STEP_NS + staged / DMMA_BLOCK_GBPS)
            + per_sm * flops / DMMA_SM_GFLOPS)


@functools.lru_cache(maxsize=None)
def _dmma_whole_grid(p: int, batch: int) -> tuple:
    """(output tile, groups) of the fp64 K2: over the ``WHOLE_DMMA_TILES``
    that divide ``p`` and every count of blocks sharing a matrix, the least
    ``_dmma_cost``, counted for a matrix's first block (it has the most
    tiles): it stages the boxes of A in its tiles' rows and columns, waits
    for them once and computes its tiles. On a tie, fewer blocks, then the
    larger tile. So a 128² operand takes 16-wide tiles, one a block (64
    blocks, each staging 30 KB of the 128 KB), and a stack of 32 of them
    64-wide ones (128 blocks). Memoised: the search walks every tile and
    group count, which would cost a small request more host time than its
    kernels take."""
    best = None
    for tile in (t for t in WHOLE_DMMA_TILES if p % t == 0):
        count = (p // tile) ** 2
        for groups in range(1, count + 1):
            mine = range(0, count, groups)
            staged = _whole_staged(p, tile, mine) * 8
            key = (_dmma_cost(groups * batch, whole_dmma_smem_bytes(p), 1,
                              staged, len(mine) * 2 * tile * tile * p),
                   groups * batch, -tile)
            if best is None or key < best[0]:
                best = (key, tile, groups)
    if best is None:
        raise ValueError(f"no whole-operand tile of {WHOLE_DMMA_TILES} "
                         f"divides {p}")
    return best[1], best[2]


def _whole_staged(p: int, tile: int, mine) -> int:
    """Elements of A a K2 block stages for its output tiles ``mine`` (on a
    ``(p, p)`` operand cut in tiles of ``tile``): the rows and the columns
    its tiles read, their crossing once."""
    per_row = p // tile
    rows = len({t // per_row for t in mine}) * tile
    cols = len({t % per_row for t in mine}) * tile
    return rows * p + p * cols - rows * cols


@functools.lru_cache(maxsize=None)
def _fma_whole_grid(p: int, batch: int) -> tuple:
    """(output tile, groups) of the f32 K2: over the ``WHOLE_F32`` tiles
    that divide ``p`` and every count of blocks sharing a matrix whose
    footprint fits a block's shared memory (every one where none fits: a
    call the kernel route refuses), the least modelled time of the busiest
    SM (``FMA_WHOLE_BLOCK_NS``, ``FMA_WHOLE_BLOCK_GBPS``,
    ``FMA_SM_GFLOPS``) for a matrix's first block (it has the most tiles):
    it stages the rows and columns of A its tiles read, waits for them once
    and computes its tiles, as many blocks at once on an SM as their shared
    memory and threads allow. On a tie, fewer blocks, then the larger tile.
    So a single 192² operand takes 16-wide tiles, one a block (144 blocks,
    five to an SM), and a stack of 32 of 128² 64-wide ones (128 blocks).
    Memoised, as the f64 rule."""
    grids = [(t, g) for t in WHOLE_F32
             if p % t == 0 and p // t <= WHOLE_F32_MAX_PER_ROW
             for g in range(1, (p // t) ** 2 + 1)]
    fitting = [(t, g) for t, g in grids
               if whole_fma_smem_bytes(p, t, g) <= SMEM_PER_BLOCK]
    best = None
    for tile, groups in fitting or grids:
        rows, cols, slices = WHOLE_F32[tile]
        footprint = whole_fma_smem_bytes(p, tile, groups)
        threads = slices * tile * tile // (rows * cols)
        resident = max(1, min(SMEM_PER_SM // (footprint
                                              + SMEM_PER_RESIDENT_BLOCK),
                              THREADS_PER_SM // threads))
        rate = FMA_SM_GFLOPS * _fma_feed(rows, cols)
        mine = range(0, (p // tile) ** 2, groups)
        blocks = groups * batch
        per_sm = -(-blocks // SM_COUNT)
        waves = -(-per_sm // resident)
        ns = (waves * (FMA_WHOLE_BLOCK_NS
                       + _whole_staged(p, tile, mine) * 4
                       / FMA_WHOLE_BLOCK_GBPS)
              + per_sm * len(mine) * 2 * tile * tile * p / rate)
        key = (ns, blocks, -tile)
        if best is None or key < best[0]:
            best = (key, tile, groups)
    if best is None:
        raise ValueError(f"no whole-operand tile of {tuple(WHOLE_F32)} "
                         f"divides {p} in at most "
                         f"{WHOLE_F32_MAX_PER_ROW} tiles a side")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _dmma_panel_grid(p: int, batch: int, chain_tile: int) -> tuple:
    """(panel height, column width, groups) of the fp64 K3: over the
    ``DMMA_PANELS`` pairs no taller than ``chain_tile`` that divide ``p``
    and every group count, the least ``_dmma_cost`` of a block that stages
    its row panel and its column tiles, one ring step per K step of each,
    and computes their output; on a tie, fewer blocks, then the taller
    panel. So 256² takes 16 x 32 tiles, one a block (128 blocks), and a
    stack of 64 of them 32-row panels (512 blocks)."""
    best = None
    for height, width in DMMA_PANELS:
        if height > chain_tile or p % height or p % width:
            continue
        block_k = dmma_panel_ring(p, height)[1]
        col_tiles = p // width
        for groups in range(1, col_tiles + 1):
            mine = -(-col_tiles // groups)
            blocks = groups * (p // height) * batch
            key = (_dmma_cost(blocks, dmma_panel_smem_bytes(p, height),
                              mine * -(-p // block_k),
                              (height + mine * width) * p * 8,
                              mine * 2 * height * width * p),
                   blocks, -height)
            if best is None or key < best[0]:
                best = (key, height, width, groups)
    if best is None:
        raise ValueError(f"no fp64 panel of {tuple(DMMA_PANELS)} no taller "
                         f"than {chain_tile} divides {p}")
    return best[1:]


def square_panel_grid(p: int, batch: int, dtype, chain_tile: int) -> tuple:
    """(panel height, column width, groups) of a panel-tier squaring (K3)
    of a ``(p, p)`` operand, or a stack of ``batch`` of them: ``groups``
    blocks share each row panel's column tiles.

    bf16 / f16 (the tensor-core K3): the chain's square tile, and as few
    groups as fill the SMs (``_groups``). f64 (the DMMA K3):
    ``_dmma_panel_grid``. f32 (the FMA K3): K3's own
    grid. Over the ``FMA_PANELS`` heights no taller than ``chain_tile``
    that divide ``p`` (the width is ``panel_width(p)``) and every group
    count, the one whose busiest SM has the least output to compute —
    blocks per SM times the column tiles of a block times a tile's area;
    on a tie the fewest waves (blocks an SM runs at once counted from
    ``fma_panel_smem_bytes``), then the fewest blocks (each stages its own
    panel), then the taller panel (more FMAs per shared load). So 512² f32
    takes 32-row panels in 128 blocks, where the chain's 64-wide tile gave
    64, and a stack of 64 of 256² 64-row panels in 256 blocks that all fit
    the card at once."""
    if dtype in (torch.float16, torch.bfloat16):
        tiles = p // chain_tile
        return chain_tile, chain_tile, _groups(tiles, tiles * batch)
    if dtype == torch.float64:
        return _dmma_panel_grid(p, batch, chain_tile)
    width = panel_width(p)
    col_tiles = p // width
    best = None
    for height in sorted(h for h, w in FMA_PANELS
                         if w == width and h <= chain_tile and p % h == 0):
        footprint = fma_panel_smem_bytes(p, height)
        resident = max(1, min(
            SMEM_PER_SM // (footprint + SMEM_PER_RESIDENT_BLOCK),
            THREADS_PER_SM // FMA_THREADS))
        for groups in range(1, col_tiles + 1):
            blocks = groups * (p // height) * batch
            per_sm = -(-blocks // SM_COUNT)
            load = per_sm * -(-col_tiles // groups) * height * width
            key = (load, -(-per_sm // resident), blocks, -height)
            if best is None or key < best[0]:
                best = (key, height, groups)
    if best is None:
        raise ValueError(f"no panel height of {FMA_PANELS} no taller than "
                         f"{chain_tile} divides {p}")
    return best[1], width, best[2]


def _kernel_tile(block_m, block_n, block_k, what, table=None) -> int:
    """The square output tile of a launch; ``table`` the (tile, K step)
    pairs of a K1 / K3 with a compile-time K step (``TC_BLOCKS``,
    ``DMMA_BLOCKS``, ``F32_BLOCKS``), which takes only those."""
    if table is not None:
        if block_m != block_n or (block_m, block_k) not in table:
            kind = "FMA" if table is F32_BLOCKS else "tensor-core"
            raise ValueError(
                f"{what}: the {kind} kernels for this dtype take square "
                f"output tiles with the (tile, K step) pairs {table}, got "
                f"blocks ({block_m},{block_n},{block_k})")
        return block_m
    if block_m != block_n or block_m not in KERNEL_TILES or block_k < 8 \
            or block_k % 8:
        raise ValueError(
            f"{what}: the CUDA kernels take square output tiles of "
            f"{KERNEL_TILES} and a K step that is a multiple of 8, got "
            f"blocks ({block_m},{block_n},{block_k})")
    return block_m


def _kernel_operand(t, name, what):
    if t.dtype not in (torch.float32, torch.float64, torch.float16,
                       torch.bfloat16):
        raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernels "
                        f"take float32, float64, float16 and bfloat16")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous, got strides "
                         f"{t.stride()} for shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned (the "
                         f"kernels use 16-byte loads)")


def _overlaps(x, y) -> bool:
    x0, y0 = x.data_ptr(), y.data_ptr()
    return (x0 < y0 + y.numel() * y.element_size()
            and y0 < x0 + x.numel() * x.element_size())


def _kernel_output(out, shape, kernel_dtype, like, inputs, what):
    """The tensor the kernel writes: ``out`` when it can take the kernel's
    output type directly, else a fresh one."""
    if out is not None:
        if tuple(out.shape) != tuple(shape) or out.device != like.device:
            raise ValueError(
                f"{what}: out has shape {tuple(out.shape)} on {out.device}, "
                f"expected {tuple(shape)} on {like.device}")
        if any(_overlaps(out, x) for x in inputs):
            # Every block reads whole panels of the operands while others
            # write the result: writing over an operand is a data race.
            raise ValueError(f"{what}: out must not alias an operand")
        if out.dtype == kernel_dtype:
            _kernel_operand(out, "out", what)
            return out
    return torch.empty(shape, dtype=kernel_dtype, device=like.device)


def _kernel_types(a, out_dtype):
    """(final out dtype, dtype the kernel writes, out_acc flag)."""
    out_dtype = out_dtype or a.dtype
    acc = accum_dtype(a.dtype)
    if out_dtype == a.dtype:
        return out_dtype, a.dtype, 0
    # Anything else is written at the accumulation width and cast after:
    # still one rounding from the fp32 / fp64 accumulator.
    return out_dtype, acc, 1


def _finish(written, out, out_dtype):
    if out is not None and written is not out:
        out.copy_(written)
        return out
    if written.dtype != out_dtype:
        return written.to(out_dtype)
    return written


def _launch(fn_name, a, args):
    """Call the C launcher for ``a``'s dtype on ``a``'s device and PyTorch's
    current stream there; raise unless it reports success."""
    lib = _build.load()
    fn = getattr(lib, f"{fn_name}_{_build.DTYPE_SUFFIX[dtype_name(a.dtype)]}")
    index = a.device.index
    # The raw handle, not ``torch.cuda.current_stream()``: building the
    # Stream object costs more host time than a small kernel runs.
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    _build.check(code, fn_name)


# ---------------------------------------------------------------------------
# K1: C = A @ B
# ---------------------------------------------------------------------------

def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 block_m: int = DEFAULT_BLOCK[0],
                 block_n: int = DEFAULT_BLOCK[1],
                 block_k: int = DEFAULT_BLOCK[2],
                 out_dtype=None, out=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`matmul_cuda`: the same shape contract,
    then widen to the accumulation dtype, ``torch.matmul``, cast once."""
    batch, m, _, n = _check_matmul(a, b, block_m, block_n, block_k)
    _record("plain_matmul", block_m,
            (m // block_m) * (n // block_n) * (batch or 1))
    return _deliver(_ref.matmul_ref(a, b, out_dtype=out_dtype or a.dtype),
                    out)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, *,
                block_m: int = DEFAULT_BLOCK[0],
                block_n: int = DEFAULT_BLOCK[1],
                block_k: int = DEFAULT_BLOCK[2],
                out_dtype=None, out=None) -> torch.Tensor:
    """Block-divisible tiled matmul, ``(M, K) @ (K, N)`` or a stack of them
    (leading dim on either or both operands; a 2-D side is shared by the
    stack). See ``ops.matmul`` for arbitrary shapes.

    fp32 accumulation for f32/bf16/f16 operands (exact IEEE fp32, no TF32),
    f64 for f64; one cast to ``out_dtype`` (default ``a.dtype``) at the
    store. bf16 / f16 run the tensor-core kernel (blocks from
    ``TC_BLOCKS``), f64 the fp64 tensor-core kernel (blocks from
    ``DMMA_BLOCKS``), f32 the FMA kernel (blocks from ``F32_BLOCKS``).
    ``out`` receives the result when
    given and must not alias an operand. On a CPU tensor this is
    :func:`matmul_plain`. A DTensor operand raises: a launch takes one
    pointer per operand, and ``ops.dense_matmul`` runs K1 on each rank's
    local shards.
    """
    if is_dtensor(a) or is_dtensor(b):
        raise TypeError("matmul_cuda: DTensor operands have no single "
                        "pointer; ops.dense_matmul runs K1 on the local "
                        "shards")
    if a.device.type == "cpu":
        return matmul_plain(a, b, block_m=block_m, block_n=block_n,
                            block_k=block_k, out_dtype=out_dtype, out=out)
    what = "matmul_cuda"
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    batch, m, k, n = _check_matmul(a, b, block_m, block_n, block_k)
    name = kernel_name("matmul", a.dtype)
    tile = _kernel_tile(block_m, block_n, block_k, what,
                        table={"matmul_tc": TC_BLOCKS,
                               "matmul_dmma": DMMA_BLOCKS,
                               "matmul": F32_BLOCKS}[name])
    _kernel_operand(a, "a", what)
    _kernel_operand(b, "b", what)
    if batch is not None and batch > 65_535:
        raise ValueError(f"{what}: a stack of {batch} exceeds the grid's "
                         f"65535 limit on its stack axis")
    if smem_footprint((tile, tile, block_k), a.element_size()) \
            > SMEM_PER_BLOCK:
        raise ValueError(f"{what}: blocks ({block_m},{block_n},{block_k}) "
                         f"need more shared memory than a block has")
    out_dtype, kernel_dtype, out_acc = _kernel_types(a, out_dtype)
    shape = (m, n) if batch is None else (batch, m, n)
    c = _kernel_output(out, shape, kernel_dtype, a, (a, b), what)
    _launch("repro_matmul", a,
            (a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, tile, block_k,
             m * k if a.ndim == 3 else 0, k * n if b.ndim == 3 else 0,
             m * n if batch is not None else 0, batch or 1, out_acc))
    _record(name, tile, (m // tile) * (n // tile) * (batch or 1))
    return _finish(c, out, out_dtype)


# ---------------------------------------------------------------------------
# K2 / K3 (and K1 by tier): C = A @ A
# ---------------------------------------------------------------------------

def square_plain(a: torch.Tensor, *,
                 block_m: int = DEFAULT_BLOCK[0],
                 block_n: int = DEFAULT_BLOCK[1],
                 block_k: int = DEFAULT_BLOCK[2],
                 out_dtype=None,
                 smem_limit: int = SQUARE_SMEM_LIMIT,
                 panel_limit: int = SQUARE_PANEL_LIMIT,
                 out=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`square_cuda`: the same tier selection,
    divisibility checks and grid bookkeeping (``last_launch``), then A @ A
    with fp32 (f64) accumulation."""
    batch, p = _check_square(a)
    tier = _resolve_tier(p, a.element_size(), block_m, block_n, block_k,
                         smem_limit, panel_limit)
    if tier == "two_operand":
        return matmul_plain(a, a, block_m=block_m, block_n=block_n,
                            block_k=block_k, out_dtype=out_dtype, out=out)
    _check_square_blocks(p, block_m, block_n)
    _record("plain_square_" + tier,
            **_square_grid(tier, p, batch or 1, a.dtype, block_m))
    return _deliver(_ref.matmul_ref(a, a, out_dtype=out_dtype or a.dtype),
                    out)


def square_cuda(a: torch.Tensor, *,
                block_m: int = DEFAULT_BLOCK[0],
                block_n: int = DEFAULT_BLOCK[1],
                block_k: int = DEFAULT_BLOCK[2],
                out_dtype=None,
                smem_limit: int = SQUARE_SMEM_LIMIT,
                panel_limit: int = SQUARE_PANEL_LIMIT,
                out=None) -> torch.Tensor:
    """C = A @ A for a block-divisible square A, ``(P, P)`` or a ``(B, P, P)``
    stack — the squaring-chain step.

    Kernel choice follows the ``square_tier`` policy on one matrix's bytes:
    the whole-operand kernel up to ``smem_limit``, the panel kernel up to
    ``panel_limit`` (demoted when ``panel_smem_footprint`` exceeds a block's
    shared memory), the two-operand :func:`matmul_cuda` above that. Both
    limits are arguments so a caller (or a tuned entry, later) can move
    them. For bf16 / f16 the panel tier is the tensor-core K3, which takes
    the ``TC_BLOCKS`` pairs only; for f32 (the FMA K3) and f64 (the DMMA
    K3) K3 launches on a panel height no taller than the chain's tile and a
    grid of its own (``square_panel_grid``). K2 takes any square chain tile of
    ``KERNEL_TILES`` that divides the operand and launches on its own output
    tile and grid (``square_whole_grid``).

    The whole-operand and panel tiers need the shape divisible by
    ``block_m`` and ``block_n``; the two-operand tier needs ``block_k`` to
    divide too. A non-divisible shape raises ``ValueError`` — ``ops.square``
    / ``ops.MatmulChain`` pad arbitrary shapes before calling in here.
    ``out`` must not alias ``a``: every block reads whole panels of A while
    others write C. On a CPU tensor this is :func:`square_plain`.
    """
    if a.device.type == "cpu":
        return square_plain(a, block_m=block_m, block_n=block_n,
                            block_k=block_k, out_dtype=out_dtype,
                            smem_limit=smem_limit, panel_limit=panel_limit,
                            out=out)
    what = "square_cuda"
    if a.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {a.device}")
    batch, p = _check_square(a)
    tier = _resolve_tier(p, a.element_size(), block_m, block_n, block_k,
                         smem_limit, panel_limit)
    if tier == "two_operand":
        return matmul_cuda(a, a, block_m=block_m, block_n=block_n,
                           block_k=block_k, out_dtype=out_dtype, out=out)
    _check_square_blocks(p, block_m, block_n)
    name = kernel_name("square_" + tier, a.dtype)
    tile = _kernel_tile(block_m, block_n, block_k, what,
                        table=TC_BLOCKS if name == "square_panel_tc"
                        else None)
    _kernel_operand(a, "a", what)
    if batch is not None and batch > 65_535:
        raise ValueError(f"{what}: a stack of {batch} exceeds the grid's "
                         f"65535 limit on its stack axis")
    if name == "square_panel_tc" and p % block_k:
        raise ValueError(
            f"shape ({p},{p}) not divisible by the K step {block_k} the "
            f"panel kernel stages the column panel in; use ops.MatmulChain "
            f"/ ops.matmul for arbitrary shapes")
    launch = _square_grid(tier, p, batch or 1, a.dtype, tile)
    if tier == "whole" and whole_smem_bytes(
            name, p, launch["tile"], launch["groups"]) > SMEM_PER_BLOCK:
        raise ValueError(
            f"{what}: smem_limit={smem_limit} sends a ({p},{p}) "
            f"{a.dtype} operand to the whole-operand kernel, but it does "
            f"not fit a block's {SMEM_PER_BLOCK} bytes of shared memory")
    out_dtype, kernel_dtype, out_acc = _kernel_types(a, out_dtype)
    c = _kernel_output(out, a.shape, kernel_dtype, a, (a,), what)
    stride = p * p if batch is not None else 0
    if tier == "whole":
        _launch("repro_square_whole", a,
                (a.data_ptr(), c.data_ptr(), p, launch["tile"], stride,
                 stride, batch or 1, launch["groups"], out_acc))
    else:
        if name == "square_panel_dmma":
            block_k = dmma_panel_ring(p, launch["tile"])[1]
        _launch("repro_square_panel", a,
                (a.data_ptr(), c.data_ptr(), p, launch["tile"],
                 launch["width"], block_k, stride, stride, batch or 1,
                 launch["groups"], out_acc))
    _record(name, **launch)
    return _finish(c, out, out_dtype)


def whole_smem_bytes(name: str, p: int, tile: int, groups: int) -> int:
    """Dynamic shared-memory bytes the K2 counted under ``name`` asks for
    over a ``(p, p)`` operand on output tiles of ``tile``, ``groups``
    blocks a matrix."""
    if name == "square_whole_tc":
        return whole_tc_smem_bytes(p)
    if name == "square_whole_dmma":
        return whole_dmma_smem_bytes(p)
    return whole_fma_smem_bytes(p, tile, groups)


def _square_grid(tier, p, batch, dtype, block_m) -> dict:
    """The grid of a squaring launch, the same on both routes: K2's from
    ``square_whole_grid`` (f32 also its K ``slices``), K3's from
    ``square_panel_grid`` (its ``tile`` is the panel height, ``width`` the
    column width of its output tiles)."""
    if tier == "whole":
        tile, groups = square_whole_grid(p, batch, dtype)
        extra = {"slices": WHOLE_F32[tile][2]} \
            if dtype == torch.float32 else {}
        return dict(tile=tile, blocks=groups * batch, groups=groups, **extra)
    tile, width, groups = square_panel_grid(p, batch, dtype, block_m)
    return dict(tile=tile, width=width,
                blocks=groups * (p // tile) * batch, groups=groups)
