#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (first use),
holds every kernel against its plain PyTorch version on the card — the FMA
kernels of ``gemm.cuh`` (K1 in f32 at every instantiated (tile, K step,
stages), K2 / K3 in f32, each on the grid of its own rule), the tensor-core
K1–K3 of ``gemm_tc.cuh`` in bf16 / f16 at every instantiated tile and
output type, the fp64 tensor-core K1–K3 of ``gemm_dmma.cuh`` (K1 at every
instantiated (tile, K step), K2 / K3 on the grids of their own rules) —
then runs the slices end to end —
``matpow_binary(a, 96, backend="cuda_chain")`` at n = 4096 (f32, bf16, f16,
f64) and in every squaring tier, the other matpow entry points, the
stacked chain and ``expm`` against float64 references; ``ops.attention``
(flash attention, K5: the tensor-core kernel of ``attention_tc.cuh`` in
bf16 / f16, the FMA kernel of ``attention.cuh`` in f32 / f64, split-KV and
its combine kernel at decode shapes) at the widths of Qwen3-1.7B and
Mixtral-8x7B against its plain version, with
``scaled_dot_product_attention`` timed beside it; and the tuning cache:
measured sweeps recorded and then used by ``ops.attention`` and by an A^96
chain, and the f64 squaring tiers measured and then used by an f64 A^96
chain. Each phase prints one JSON line; any
failure raises and the script exits non-zero without the final
``"ok": true`` line. It needs a CUDA device and ``nvcc``; it imports
``repro_torch`` only (never ``jax`` or the reference package). The tuning
cache it reads and writes is a temporary file of its own.

Kernel timings are CUDA-event medians over replays of a CUDA graph of
back-to-back calls (device time, without the host's per-call work); request
timings are host-clock medians ending in a synchronise. ``bound_ms`` is the
least time the card could take: max(operations / peak rate, bytes / memory rate), with
the H100 SXM data-sheet rates below.
"""

from __future__ import annotations

import collections
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# cuBLAS is deterministic across streams only with a fixed workspace
# (PyTorch's reproducibility notes); phase serve_daemon holds the "torch"
# route to the same bits under any stream count, so it is set before CUDA
# starts.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (batched_expm, batched_matpow, expm,  # noqa: E402
                              matpow_binary, matpow_binary_traced,
                              matpow_naive)
from repro_torch.kernels import (_build, autotune, error_budget, ops,  # noqa: E402
                                 ref)
from repro_torch.kernels import attention_kernels as A  # noqa: E402
from repro_torch.kernels import matmul_kernels as K  # noqa: E402
from repro_torch.launch import matserve  # noqa: E402
from repro_torch.serve import (ExecutionStreams, ManualClock,  # noqa: E402
                               MatFnEngine)

# NVIDIA H100 SXM data sheet, dense rates, the fastest pipeline the card has
# for each type, so that the bound is the least time the card could take
# whatever pipeline a kernel uses: the tensor cores for bf16 / fp16 and for
# fp64 (67 TFLOP/s, twice its FMA pipeline's 34); fp32 outside them (the
# tensor cores take fp32 only as TF32, which is not fp32).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12

SOURCES = {"matmul": "src/repro_torch/kernels/csrc/gemm.cuh",
           "matmul_tc": "src/repro_torch/kernels/csrc/gemm_tc.cuh",
           "matmul_dmma": "src/repro_torch/kernels/csrc/gemm_dmma.cuh",
           "square_whole": "src/repro_torch/kernels/csrc/gemm.cuh",
           "square_whole_tc": "src/repro_torch/kernels/csrc/gemm_tc.cuh",
           "square_whole_dmma": "src/repro_torch/kernels/csrc/gemm_dmma.cuh",
           "square_panel": "src/repro_torch/kernels/csrc/gemm.cuh",
           "square_panel_tc": "src/repro_torch/kernels/csrc/gemm_tc.cuh",
           "square_panel_dmma": "src/repro_torch/kernels/csrc/gemm_dmma.cuh",
           "flash_attention": "src/repro_torch/kernels/csrc/attention.cuh",
           "flash_attention_tc":
               "src/repro_torch/kernels/csrc/attention_tc.cuh",
           "attn_combine": "src/repro_torch/kernels/csrc/attention.cuh"}
REPLACES = {"matmul": "src/repro/kernels/matmul.py:111",
            "matmul_tc": "src/repro/kernels/matmul.py:111",
            "matmul_dmma": "src/repro/kernels/matmul.py:111",
            "square_whole": "src/repro/kernels/matmul.py:275",
            "square_whole_tc": "src/repro/kernels/matmul.py:275",
            "square_whole_dmma": "src/repro/kernels/matmul.py:275",
            "square_panel": "src/repro/kernels/matmul.py:287",
            "square_panel_tc": "src/repro/kernels/matmul.py:287",
            "square_panel_dmma": "src/repro/kernels/matmul.py:287",
            "flash_attention": "src/repro/kernels/attention.py:155",
            "flash_attention_tc": "src/repro/kernels/attention.py:155",
            "attn_combine": "src/repro/kernels/attention.py:155"}
#: The rows of the ``{"kernels": [...]}`` line: (kernel, label of its timed
#: main-path shape: the dtype, and for a kernel timed at two shapes of one
#: dtype the shape's name too). K5 on the tensor cores at Qwen3-1.7B
#: prefill; K5 on the FMA pipeline at f32 decode, f32 prefill and f64
#: decode; the combine at bf16 decode.
KERNEL_ROWS = (("matmul", "float32"), ("matmul_tc", "bfloat16"),
               ("matmul_tc", "float16"), ("matmul_dmma", "float64"),
               ("square_whole", "float32"), ("square_whole_tc", "bfloat16"),
               ("square_whole_tc", "float16"),
               ("square_panel", "float32"), ("square_panel_tc", "bfloat16"),
               ("square_panel_tc", "float16"),
               ("square_whole_dmma", "float64"),
               ("square_panel_dmma", "float64"),
               ("flash_attention_tc", "bfloat16"),
               ("flash_attention", "float32"),
               ("flash_attention", "float32 prefill"),
               ("flash_attention", "float64"), ("attn_combine", "bfloat16"))
DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
SIXTEEN_BIT = (torch.bfloat16, torch.float16)
POWER = 96          # 6 squarings + 1 combine
MULTS = 7
WRONG_POWER = 64    # what a chain that lost its combine would return

# Kernel against plain version: both accumulate in fp32 (fp64 for fp64) and
# round once to the output type, so they may differ by the summation order
# and by one unit in the last place of the output — 2^-8 of an entry in
# bf16, 2^-10 in f16. The limit is on the largest error over the largest
# entry of the plain result (the operands are zero-mean, so small entries are
# sums that cancelled and carry the error of the large ones).
KERNEL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2,
               torch.float16: 2e-3, torch.float64: 1e-12}
# K5 is held to the same numbers PER QUERY ROW: each row's largest error over
# that row's largest entry (``ref.row_relative_error``). An attention
# output's scale varies by row — row 0 of a causal output is v[0], a row
# that averages n keys is about n^-1/2 of that — so a limit on the whole
# output's peak would pass a kernel that dropped a KV tile for the later
# rows. Per row, 1e-2 in bf16 and 2e-3 in f16 are 1.3 and 2 units in the
# last place of the row's largest entry. K5 computes float64 inputs in fp32,
# as the reference does: its limit there is the fp32 one.
ATTN_RTOL = {**KERNEL_RTOL, torch.float64: 1e-4}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, *, reps: int = 5) -> float:
    """Median device time of one ``fn()`` in milliseconds: CUDA-event
    timings of replays of a CUDA graph of back-to-back calls
    (``autotune.device_times_us``), so the host's work per call is outside
    the measurement. The 50 MB L2 is not flushed between calls: inside a
    chain the operand of every multiply was written by the one before."""
    return statistics.median(autotune.device_times_us(fn, reps)) / 1e3


def wall_ms(fn) -> float:
    """Median host-clock time of one ``fn()`` ending in a synchronise, over
    3 to 51 calls (about 30 ms of them: short requests vary with the host)."""
    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    reps = max(3, min(51, int(30.0 / max(once(), 1e-3))))
    return statistics.median(once() for _ in range(reps))


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def errors(got, want) -> tuple:
    """(max abs error, max abs error over the reference's largest entry)."""
    diff = (got.double() - want.double()).abs().max().item()
    peak = want.double().abs().max().item()
    return diff, diff / max(peak, 1e-300)


def check_close(got, want, dtype, *, n, mults=1, what) -> tuple:
    """Hold ``got`` to ``want`` under ``error_budget(dtype, n, mults)``,
    elementwise, and — because the budget's absolute floor is loose for
    small-valued results — also hold the peak-relative error to its rtol."""
    rtol, atol = error_budget(dtype, n=n, mults=mults)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values in the result")
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    abs_err, rel_peak = errors(got, want)
    ok = torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol)
    floor_rtol = error_budget(dtype)[0]
    if not ok or rel_peak > floor_rtol:
        raise AssertionError(
            f"{what}: max_abs_err={abs_err:.3e} rel_to_peak={rel_peak:.3e} "
            f"outside rtol={rtol:.3e} atol={atol:.3e} "
            f"(peak-relative limit {floor_rtol:.3e})")
    return abs_err, rel_peak, rtol, atol


def check_kernel(got, want, dtype, *, what, rtol=KERNEL_RTOL,
                 per_row=False) -> tuple:
    """Hold a kernel's result to its plain version's under ``rtol[dtype]``,
    relative to the plain result's largest entry — or, with ``per_row``, to
    each row's largest entry (``ref.row_relative_error``). Returns (max abs
    error, error over the largest entry, worst row's error over its largest
    entry)."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values in the result")
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(want.shape)} {want.dtype}")
    abs_err, rel_peak = errors(got, want)
    rel_row = ref.row_relative_error(got, want)
    if rel_peak > rtol[dtype] or (per_row and rel_row > rtol[dtype]):
        raise AssertionError(
            f"{what}: max_abs_err={abs_err:.3e} is {rel_peak:.3e} of the "
            f"largest entry and up to {rel_row:.3e} of a row's largest, "
            f"limit {rtol[dtype]:.1e}" + (" per row" if per_row else ""))
    return abs_err, rel_peak, rel_row


def randn(shape, dtype, seed, scale=None):
    """Zero-mean normal operand from a numpy seed; the default scale
    K^-1/4 (K the last dim) keeps a product of two of them at O(1)."""
    rng = np.random.default_rng(seed)
    if scale is None:
        scale = shape[-1] ** -0.25
    return convert.from_reference(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(scale),
        dtype=dtype)


def power_operand(n, dtype, seed, batch=None, eps=1.0 / 32):
    """Row-stochastic matrix whose powers stay bounded and distinct:
    ``(1 - eps) * P + eps * S``, P the permutation matrix of one random
    n-cycle, S dense random row-stochastic, from a numpy seed.

    Every power is row-stochastic, so A^96 neither overflows nor underflows.
    A dense random S alone would not do: its second eigenvalue is near
    1/sqrt(n), S^4 equals S^96 to rounding, and a chain that squared too few
    times would pass. Here row i of A^p peaks at about (1 - eps)^p where
    P^p sends i, so a wrong exponent moves the peak's place and its size.
    """
    rng = np.random.default_rng(seed)
    count = 1 if batch is None else batch
    out = np.empty((count, n, n), np.float32)
    for m in out:
        s = rng.random((n, n), dtype=np.float32) + np.float32(0.05)
        m[:] = np.float32(eps) * s / s.sum(axis=-1, keepdims=True)
        cycle = rng.permutation(n)
        m[cycle, np.roll(cycle, -1)] += np.float32(1.0 - eps)
    return convert.from_reference(out[0] if batch is None else out,
                                  dtype=dtype)


def f64_power(a, p, *, what):
    """A^p in float64 on the card, after showing that the check can see the
    exponent: A^p must differ from A^q, q the power one lost combine or
    one lost multiply away, by at least half its own largest entry (the
    loosest tolerance below is 0.15 of it)."""
    a64 = a.double()
    want = torch.linalg.matrix_power(a64, p)
    if p == 0:
        return want
    q = WRONG_POWER if p == POWER else p - 1
    _, rel = errors(torch.linalg.matrix_power(a64, q), want)
    if rel < 0.5:
        raise AssertionError(f"{what}: A^{q} is within {rel:.3e} of A^{p}: "
                             f"the operand hides the exponent")
    return want


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         matmul_settings=repro_torch.exact_matmul_settings(),
         float32_matmul_precision=torch.get_float32_matmul_precision())
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         sources=[str(p.name) for p in _build.sources()],
         flags=list(_build.NVCC_FLAGS))


def kernel_case(name, dtype, operands, blocks, *, timed, rows,
                out_dtype=None, **limits):
    """Run one kernel wrapper and its plain version on the same CUDA
    tensors, compare, optionally time; append a row. ``limits`` moves the
    squaring-tier limits (to force the panel kernel on a small operand);
    ``out_dtype`` asks for another output type than the operands'."""
    bm, bn, bk = blocks
    kw = dict(block_m=bm, block_n=bn, block_k=bk, out_dtype=out_dtype,
              **limits)
    if name == "matmul":
        a, b = operands
        run = lambda: K.matmul_cuda(a, b, **kw)
        plain = lambda: K.matmul_plain(a, b, **kw)
        library = lambda: torch.matmul(a, b)
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        batch = a.shape[0] if a.ndim == 3 else (
            b.shape[0] if b.ndim == 3 else 1)
        nbytes = (a.numel() + b.numel() + batch * m * n) * a.element_size()
        shape = f"{tuple(a.shape)}@{tuple(b.shape)}"
    else:
        (a,) = operands
        run = lambda: K.square_cuda(a, **kw)
        plain = lambda: K.square_plain(a, **kw)
        library = lambda: torch.matmul(a, a)
        m = k = n = a.shape[-1]
        batch = a.shape[0] if a.ndim == 3 else 1
        nbytes = 2 * a.numel() * a.element_size()
        shape = f"{tuple(a.shape)}^2"
    kernel = K.kernel_name(name, dtype)
    out_dtype = out_dtype or dtype
    before = K.launch_counts()
    got = run()
    torch.cuda.synchronize()
    launch = dict(K.last_launch)
    after = K.launch_counts()
    if after[kernel] != before[kernel] + 1 or sum(after.values()) \
            != sum(before.values()) + 1:
        raise AssertionError(f"{name} {shape} {dtype}: expected one launch "
                             f"of {kernel}, counters went {before} -> "
                             f"{after}")
    want = plain()
    abs_err, rel_peak, _ = check_kernel(
        got, want, out_dtype, what=f"kernel {kernel} {shape} {dtype} -> "
                                   f"{out_dtype}")
    row = {"name": kernel, "dtype": str(dtype).removeprefix("torch."),
           "out_dtype": str(out_dtype).removeprefix("torch."),
           "shape": shape, "blocks": list(blocks), "tile": launch["tile"],
           "grid_blocks": launch["blocks"], "width": launch.get("width"),
           "groups": launch.get("groups"), "slices": launch.get("slices"),
           "max_abs_err": abs_err,
           "rel_to_peak": rel_peak, "rel_to_peak_limit": KERNEL_RTOL[out_dtype]}
    if timed:
        b_ms, b_by = bound(2.0 * batch * m * n * k, nbytes, dtype)
        row.update(ms=time_ms(run), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)
        if name != "matmul":
            # the same squaring through the two-operand kernel, to show what
            # the tier buys (or costs) at this shape
            row["two_operand_ms"] = time_ms(
                lambda: K.matmul_cuda(a, a, block_m=bm, block_n=bn,
                                      block_k=bk))
    rows.append(row)
    return row


def emit_k2_grid(row) -> None:
    """K2's tile, grid and K slices on a timed operand, beside K1 on the
    same operand (``two_operand_ms``: the squaring with the tiers off) and
    the library."""
    emit("k2_grid", kernel=row["name"], dtype=row["dtype"],
         shape=row["shape"], tile=row["tile"], groups=row["groups"],
         slices=row["slices"], grid_blocks=row["grid_blocks"], ms=row["ms"],
         k1_ms=row["two_operand_ms"], library_ms=row["library_ms"],
         bound_ms=row["bound_ms"])


def phase_kernels() -> dict:
    """K1, K2, K3 — 2-D and stacked — against their plain versions on the
    card, for f32, bf16, f16 and f64 (the 16-bit K1 and K3, the f64 K1 and
    the f32 K1 at every instantiated (tile, K step) and both output types;
    the 16-bit K2 at both output types; K2 f32 at the tiles 16 and 64 its
    grid rule picks, K2 f64 on its own tiles and grids; K3 f32 / f64 on the
    panel heights and grids their rules pick); timed at the main path's
    shapes."""
    rows = []
    for dtype in DTYPES:
        if dtype in SIXTEEN_BIT:
            tilings = [((t, t, bk), out) for t, bk in K.TC_BLOCKS
                       for out in (None, torch.float32)]
            stacked = (64, 64, 32)
        elif dtype == torch.float64:
            tilings = [((t, t, bk), out) for t, bk in K.DMMA_BLOCKS
                       for out in (None, torch.float32)]
            stacked = (64, 64, 16)
        else:
            tilings = [((t, t, bk), None) for t, bk in K.F32_BLOCKS]
            stacked = (64, 64, 16)
        # M != N != K, K a multiple of every K step and several ring stages
        a = randn((256, 384), dtype, 1)
        b = randn((384, 128), dtype, 2, 384 ** -0.25)
        for blocks, out in tilings:
            kernel_case("matmul", dtype, (a, b), blocks, timed=False,
                        rows=rows, out_dtype=out)
        a3 = randn((3, 256, 384), dtype, 3)
        b3 = randn((3, 384, 128), dtype, 4, 384 ** -0.25)
        kernel_case("matmul", dtype, (a3, b3), stacked, timed=False,
                    rows=rows)
        kernel_case("matmul", dtype, (a3, b), stacked, timed=False,
                    rows=rows)
        kernel_case("matmul", dtype, (a, b3), stacked, timed=False,
                    rows=rows)
        # whole-operand tier: the operand must fit a block's shared memory;
        # K2 picks its tile (16-bit: 32 for one matrix, 64 for the two
        # stacks; f32 and f64: 16 for one matrix, 64 for the stacks, up to
        # the tier's largest operand, 224^2 and 160^2)
        p_whole = 128 if dtype == torch.float64 else 192
        shapes = [(p_whole, p_whole), (32, 128, 128), (33, 128, 128)]
        if dtype in SIXTEEN_BIT:
            shapes.append((256, 256))
        if dtype == torch.float64:
            shapes.append((160, 160))
        if dtype == torch.float32:
            shapes.append((224, 224))     # the f32 tier's largest operand
        for i, shape in enumerate(shapes):
            a = randn(shape, dtype, 5 + i)
            blocks = ops._square_blocks(shape[-1], dtype)[0]
            if shape[-1] % blocks[0]:
                blocks = (32, 32, 16)
            for out in (None, torch.float32) if dtype in SIXTEEN_BIT \
                    else (None,):
                kernel_case("square_whole", dtype, (a,), blocks,
                            timed=False, rows=rows, out_dtype=out)
        # panel tier
        p_panel = 256 if dtype == torch.float64 else 512
        if dtype not in SIXTEEN_BIT:
            tilings = [((t, t, 16), None) for t in (32, 64)]
        a = randn((p_panel, p_panel), dtype, 7)
        for blocks, out in tilings:
            kernel_case("square_panel", dtype, (a,), blocks, timed=False,
                        rows=rows, out_dtype=out, smem_limit=0)
        kernel_case("square_panel", dtype,
                    (randn((64, 256, 256), dtype, 8),),
                    stacked, timed=False, rows=rows, smem_limit=0)
        if dtype not in SIXTEEN_BIT:
            # an odd stack, and a size only 32 divides (32-wide columns)
            kernel_case("square_panel", dtype,
                        (randn((33, 128, 128), dtype, 9),),
                        stacked, timed=False, rows=rows, smem_limit=0)
            kernel_case("square_panel", dtype,
                        (randn((3, 288, 288), dtype, 9),),
                        (32, 32, 16), timed=False, rows=rows, smem_limit=0)
        if dtype == torch.float64:
            # the f64 panel tier's last size at the chain's tile
            kernel_case("square_panel", dtype,
                        (randn((384, 384), dtype, 9),), stacked,
                        timed=False, rows=rows, smem_limit=0)

    # The main path's own shapes, timed: the n = 4096 chain runs K1 for its
    # squarings and its combine (f64 on DMMA); n = 192 f32, n = 256 bf16
    # and n = 128 f64 square in K2, n = 512 f32 and n = 1024 bf16 in K3
    # (phase matpow). K2 in bf16 / f16 is also timed at 192², where the FMA
    # K2 was compared with the library, and K3 at 512² in bf16 and f16, an
    # earlier point of comparison; the kernels line takes a kernel's last
    # row here, the main path's. The operands are zero-mean here too, so a
    # dropped K step, a transposed product or a misplaced tile moves entries
    # by their own size.
    timed = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16,
                  torch.float64):
        a = randn((4096, 4096), dtype, 10)
        b = randn((4096, 4096), dtype, 11)
        blocks, _ = ops._square_blocks(4096, dtype)
        row = kernel_case("matmul", dtype, (a, b), blocks, timed=True,
                          rows=rows)
        timed.setdefault((row["name"], row["dtype"]), row)
        if dtype == torch.float64:
            emit("k1_f64_grid", kernel=row["name"], shape=row["shape"],
                 tile=row["tile"], grid_blocks=row["grid_blocks"],
                 ms=row["ms"], bound_ms=row["bound_ms"],
                 library_ms=row["library_ms"])
        if dtype in (torch.float32, torch.bfloat16):
            # the same product at half the K step: what the default buys
            kernel_case("matmul", dtype, (a, b),
                        (blocks[0], blocks[1], blocks[2] // 2), timed=True,
                        rows=rows)
        del a, b
    for name, n, dtypes in (
            ("square_whole", 192, (torch.float32, torch.bfloat16,
                                   torch.float16)),
            ("square_whole", 256, (torch.bfloat16, torch.float16)),
            ("square_panel", 512, (torch.float32, torch.bfloat16,
                                   torch.float16)),
            ("square_panel", 1024, (torch.bfloat16,))):
        for dtype in dtypes:
            a = randn((n, n), dtype, 12)
            blocks, padded = ops._square_blocks(n, dtype)
            assert padded == n
            row = kernel_case(name, dtype, (a,), blocks, timed=True, rows=rows)
            timed[(row["name"], row["dtype"])] = row
            if name == "square_panel" and dtype == torch.float32:
                k3_f32 = row
            if name == "square_whole":
                emit_k2_grid(row)
    # One more timed point each for the stacked shapes of phase 6.
    stack = kernel_case("square_panel", torch.float32,
                        (randn((64, 256, 256), torch.float32, 13),),
                        ops._square_blocks(256, torch.float32)[0], timed=True,
                        rows=rows)
    emit_k2_grid(kernel_case("square_whole", torch.float32,
                             (randn((32, 128, 128), torch.float32, 14),),
                             ops._square_blocks(128, torch.float32)[0],
                             timed=True, rows=rows))
    # K3 f32's grid, beside K1 on the same operands (``two_operand_ms``: the
    # squaring with panel_limit=0), the K1-vs-K3 reading for the f32 panel
    # tier.
    for row in (k3_f32, stack):
        emit("k3_grid", kernel=row["name"], dtype=row["dtype"],
             shape=row["shape"], blocks=row["blocks"], tile=row["tile"],
             width=row["width"], grid_blocks=row["grid_blocks"],
             groups=row["groups"], ms=row["ms"], k1_ms=row["two_operand_ms"],
             library_ms=row["library_ms"], bound_ms=row["bound_ms"])
    # K2 and K3 in f64, on the fp64 tensor cores, at their tiers'
    # main-path sizes (the n = 128 f64 request squares in K2, n = 256 in
    # K3), each beside K1 on the same operand (``two_operand_ms``).
    for name, n in (("square_whole", 128), ("square_panel", 256)):
        a = randn((n, n), torch.float64, 15)
        row = kernel_case(name, torch.float64, (a,),
                          ops._square_blocks(n, torch.float64)[0],
                          timed=True, rows=rows)
        timed[(row["name"], row["dtype"])] = row
        emit("k2_grid" if name == "square_whole" else "k3_grid",
             kernel=row["name"], dtype=row["dtype"], shape=row["shape"],
             tile=row["tile"], width=row["width"],
             grid_blocks=row["grid_blocks"], groups=row["groups"],
             ms=row["ms"], two_operand_ms=row["two_operand_ms"],
             library_ms=row["library_ms"], bound_ms=row["bound_ms"])
    emit("kernels", kernels=sorted(f"{k} {d}" for k, d in timed),
         cases=len(rows), rows=rows)
    return timed


def matpow_case(n, dtype, expect_tier, seed):
    """One main-path request: A^96 through the fused chain, checked against
    the float64 power and the ``"torch"`` route, launches counted."""
    what = f"matpow_binary(n={n}, {dtype}, p={POWER}, cuda_chain)"
    a = power_operand(n, dtype, seed)
    keep = a.clone()
    want = f64_power(a, POWER, what=what)

    before = K.launch_counts()
    got = matpow_binary(a, POWER, backend="cuda_chain")
    torch.cuda.synchronize()
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    expected = {k: 0 for k in after}
    k1 = K.kernel_name("matmul", dtype)
    if expect_tier == "two_operand":
        expected[k1] = 7
    else:
        expected[K.kernel_name("square_" + expect_tier, dtype)] = 6
        expected[k1] = 1
    if delta != expected:
        raise AssertionError(f"matpow n={n} {dtype}: launches {delta}, "
                             f"expected {expected}")
    if not torch.equal(a, keep):
        raise AssertionError(f"matpow n={n} {dtype}: caller's operand "
                             f"was written")
    abs_err, rel_peak, rtol, atol = check_close(
        got, want, dtype, n=n, mults=MULTS,
        what=what + " vs float64")
    via_torch = matpow_binary(a, POWER, backend="torch")
    t_abs, t_rel, _, _ = check_close(got, via_torch, dtype, n=n, mults=MULTS,
                                     what=what + " vs torch route")
    del want, via_torch
    chain_ms = wall_ms(lambda: matpow_binary(a, POWER, backend="cuda_chain"))
    torch_ms = wall_ms(lambda: matpow_binary(a, POWER, backend="torch"))
    return {"n": n, "dtype": str(dtype).removeprefix("torch."),
            "tier": expect_tier, "launches": delta,
            "max_abs_err_vs_f64": abs_err, "rel_to_peak_vs_f64": rel_peak,
            "max_abs_err_vs_torch": t_abs, "rtol": rtol, "atol": atol,
            "rel_to_peak_limit": error_budget(dtype)[0],
            "cuda_chain_ms": chain_ms, "torch_ms": torch_ms}


def phase_matpow() -> tuple:
    """The slice itself at full width. Counters are zeroed just before and
    read just after; every kernel must have been launched."""
    K.reset_launches()
    rows = [
        matpow_case(4096, torch.float32, "two_operand", 20),
        matpow_case(4096, torch.bfloat16, "two_operand", 21),
        matpow_case(4096, torch.float16, "two_operand", 27),
        matpow_case(3000, torch.float32, "two_operand", 22),
        matpow_case(192, torch.float32, "whole", 23),
        matpow_case(512, torch.float32, "panel", 24),
        matpow_case(1024, torch.bfloat16, "panel", 25),
        matpow_case(256, torch.bfloat16, "whole", 26),
        matpow_case(4096, torch.float64, "two_operand", 28),
        matpow_case(128, torch.float64, "whole", 29),
        matpow_case(256, torch.float64, "panel", 31),
    ]
    counts = K.launch_counts()
    for name in K.KERNELS:
        if counts[name] < 1:
            raise AssertionError(f"main path never launched {name}: {counts}")
    plain = {k: v for k, v in counts.items() if k.startswith("plain_")}
    if any(plain.values()):
        raise AssertionError(f"main path took the plain route: {plain}")
    emit("matpow", power=POWER, launches=counts, rows=rows)
    return counts, rows


def phase_entry_points() -> None:
    n = 512
    a = power_operand(n, torch.float32, 30)
    out = {}
    for backend in ("cuda", "cuda_chain"):
        got = matpow_naive(a, 5, backend=backend)
        out[f"naive_{backend}"] = check_close(
            got, f64_power(a, 5, what="matpow_naive"), torch.float32, n=n,
            mults=4, what=f"matpow_naive {backend}")[0]
    for p in (0, 1, 13, 96):
        want = f64_power(a, p, what=f"matpow_binary_traced p={p}")
        mults = max(p.bit_length() - 1, 0) + max(bin(p).count("1") - 1, 0)
        for backend in ("cuda", "cuda_chain"):
            before = K.launch_counts()
            got = matpow_binary_traced(
                a, torch.tensor(p, device="cuda", dtype=torch.int32),
                backend=backend)
            torch.cuda.synchronize()
            after = K.launch_counts()
            launched = sum(after[k] - before[k] for k in K.KERNELS)
            if launched != mults:
                raise AssertionError(f"traced p={p} {backend}: {launched} "
                                     f"launches, expected {mults}")
            out[f"traced_{backend}_p{p}"] = check_close(
                got, want, torch.float32, n=n, mults=max(mults, 1),
                what=f"matpow_binary_traced p={p} {backend}")[0]
    if not torch.equal(matpow_binary_traced(a, -3, backend="cuda_chain"),
                       torch.eye(n, device="cuda")):
        raise AssertionError("negative traced power must give the identity")
    per_call = wall_ms(lambda: matpow_binary(a, POWER, backend="cuda"))
    chain = wall_ms(lambda: matpow_binary(a, POWER, backend="cuda_chain"))
    emit("matpow_entry_points", n=n, max_abs_err=out,
         per_call_cuda_ms=per_call, cuda_chain_ms=chain)


def phase_batched() -> None:
    stack = power_operand(256, torch.float32, 40, batch=64)
    keep = stack.clone()
    before = K.launch_counts()
    got = batched_matpow(stack, 7, backend="cuda_chain")
    torch.cuda.synchronize()
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    # p = 7: two stacked squarings, two stacked combines, one launch each.
    if delta != {"square_panel": 2, "matmul": 2}:
        raise AssertionError(f"batched_matpow launches {delta}")
    if not torch.equal(stack, keep):
        raise AssertionError("batched_matpow wrote the caller's stack")
    pow_err = check_close(got, f64_power(stack, 7, what="batched_matpow"),
                          torch.float32, n=256, mults=4,
                          what="batched_matpow (64,256,256) p=7")[0]
    pow_ms = wall_ms(lambda: batched_matpow(stack, 7, backend="cuda_chain"))
    pow_torch_ms = wall_ms(lambda: batched_matpow(stack, 7, backend="torch"))

    rng = np.random.default_rng(41)
    mats = rng.standard_normal((32, 128, 128)) * 0.3
    mats[0] = 60.0 * np.eye(128)
    mats[1] = 100.0 * np.eye(128)
    x = convert.from_reference(mats, dtype=torch.float32)
    before = K.launch_counts()
    got = batched_expm(x, backend="cuda_chain")
    torch.cuda.synchronize()
    after = K.launch_counts()
    squarings = after["square_whole"] - before["square_whole"]
    # s of the stack's largest member, 100 * I: ceil(log2(100 / theta13))
    if squarings != 5 or after["matmul"] != before["matmul"]:
        raise AssertionError(f"batched_expm: {squarings} stacked squarings "
                             f"(expected 5), counters {before} -> {after}")
    via_torch = batched_expm(x, backend="torch")
    want = torch.linalg.matrix_exp(x.double())
    small = got[0]
    if not torch.isfinite(small).all():
        raise AssertionError("expm: the early-finishing 60*I member is not "
                             "finite")
    e60 = float(np.exp(np.float32(60.0)))
    if not torch.allclose(torch.diagonal(small),
                          torch.full((128,), e60, device="cuda"), rtol=1e-5):
        raise AssertionError("expm: the 60*I member lost its value")
    if torch.isnan(got[1]).any():
        raise AssertionError("expm: overflow of the 100*I member must be "
                             "inf, never NaN")
    if not torch.equal(torch.isnan(got), torch.isnan(via_torch)):
        raise AssertionError("expm: NaN where the torch route has none")
    exp_err = check_close(got[2:], want[2:], torch.float32, n=128, mults=8,
                          what="batched_expm (32,128,128)")[0]
    solo = expm(x[0], backend="cuda_chain")
    if not torch.equal(solo, got[0]):
        raise AssertionError("expm: batching perturbed the 60*I member")
    emit("batched", matpow_max_abs_err=pow_err, matpow_launches=delta,
         matpow_cuda_chain_ms=pow_ms, matpow_torch_ms=pow_torch_ms,
         expm_max_abs_err=exp_err, expm_stacked_squarings=squarings)


#: ops.attention's main-path shapes: (name, leading dims, Sq, Skv, d, dtype,
#: causal, window, timed). Qwen3-1.7B prefill (configs/qwen3_1_7b.py: 16
#: query heads of d_head 128) at 4096 tokens; Mixtral-8x7B's sliding window
#: (configs/mixtral_8x7b.py: window 4096, d_head 4096 / 32 = 128) over 8192
#: tokens, and the same without the window (what the band skip saves);
#: decode alignment (128 new queries against 4096 keys, f32 and bf16: one
#: query block per head, so the KV bands split); Sq > Skv (no key for rows
#: 0..127, f32 and bf16); float16, float64 and a head width that pads. The
#: FMA kernel (f32 / f64) is timed at decode in both types and at the
#: Qwen3-1.7B prefill in f32.
ATTN_CASES = (
    ("qwen3_1.7b_prefill", (16,), 4096, 4096, 128, torch.bfloat16, True,
     None, True),
    ("qwen3_1.7b_prefill_f32", (16,), 4096, 4096, 128, torch.float32, True,
     None, True),
    ("mixtral_8x7b_window", (8,), 8192, 8192, 128, torch.bfloat16, True,
     4096, True),
    ("mixtral_8x7b_causal", (8,), 8192, 8192, 128, torch.bfloat16, True,
     None, True),
    ("decode_f32", (16,), 128, 4096, 128, torch.float32, True, None, True),
    ("decode_bf16", (16,), 128, 4096, 128, torch.bfloat16, True, None, True),
    ("decode_f64", (16,), 128, 4096, 128, torch.float64, True, None, True),
    ("sq_gt_skv", (1,), 256, 128, 64, torch.float32, True, None, False),
    ("sq_gt_skv_bf16", (1,), 256, 128, 64, torch.bfloat16, True, None,
     False),
    ("f16", (4,), 512, 512, 64, torch.float16, True, None, False),
    ("f64_window", (2,), 256, 256, 128, torch.float64, True, 100, False),
    ("d48_pads", (2, 3), 192, 192, 48, torch.float32, False, None, False),
)


def attention_pairs(sq, skv, causal, window) -> int:
    """(query, key) pairs the masks leave visible — the work a kernel that
    skips masked tiles has to do for one slice."""
    q_pos = torch.arange(sq, dtype=torch.int64)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, dtype=torch.int64)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return int(mask.sum())


def sdpa_call(q, k, v, causal, window):
    """The library's fused attention on the same function: is_causal where
    the mask is the square causal one, else an explicit boolean mask
    (right-aligned or windowed). The heads go on a fourth axis, (1, H, S,
    D): on 3-D inputs the library takes its unfused path. Timed as the
    yardstick only."""
    sq, skv = q.shape[-2], k.shape[-2]
    q, k, v = (x.reshape(1, -1, *x.shape[-2:]) for x in (q, k, v))
    if causal and window is None and sq == skv:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)


def phase_attention() -> tuple:
    """K5 through ``ops.attention`` (blocks from the tuning cache, empty
    here, so the heuristic's), counted by route: bf16 / f16 on the
    tensor-core kernel, f32 / f64 on the FMA kernel, the combine once for
    each call whose KV bands split. Then each output against the plain
    version on the same inputs, the timed shapes against their bound and
    the library's call, and the combine kernel against its plain version on
    the partials of the bf16 decode call, recomputed in plain PyTorch."""
    cases = []
    for i, (name, lead, sq, skv, d, dtype, causal, window, timed) in \
            enumerate(ATTN_CASES):
        rng = np.random.default_rng(50 + i)
        q, k, v = (convert.from_reference(
            rng.standard_normal((*lead, s, d), dtype=np.float32), dtype=dtype)
            for s in (sq, skv, skv))
        cases.append((name, q, k, v, causal, window, timed))

    A.reset_launches()
    outs, launched = [], []
    for _, q, k, v, causal, window, _ in cases:
        outs.append(ops.attention(q, k, v, causal=causal, window=window))
        launched.append(dict(A.last_launch))
    torch.cuda.synchronize()
    counts = A.launch_counts()
    expected = {name: 0 for name in counts}
    for (_, q, *_), launch in zip(cases, launched):
        expected[A.kernel_name(q.dtype)] += 1
        expected["attn_combine"] += launch["splits"] > 1
    if counts != expected:
        raise AssertionError(f"ops.attention launches {counts}, expected "
                             f"{expected}")

    rows = []
    for (name, q, k, v, causal, window, timed), got, launch in zip(
            cases, outs, launched):
        kw = dict(causal=causal, window=window)
        if launch["kernel"] != A.kernel_name(q.dtype):
            raise AssertionError(f"{name}: {q.dtype} went to "
                                 f"{launch['kernel']}")
        want = A.flash_attention_plain(q, k, v, **kw)
        abs_err, rel_peak, rel_row = check_kernel(
            got, want, q.dtype, what=f"flash_attention {name}",
            rtol=ATTN_RTOL, per_row=True)
        sq, skv, d = q.shape[-2], k.shape[-2], q.shape[-1]
        row = {"name": name, "kernel": launch["kernel"],
               "dtype": str(q.dtype).removeprefix("torch."),
               "shape": f"q{tuple(q.shape)} kv{tuple(k.shape)}",
               "causal": causal, "window": window,
               "blocks": [launch["block_q"], launch["block_k"]],
               "tile": list(launch["tile"]), "splits": launch["splits"],
               "max_abs_err": abs_err, "rel_to_peak": rel_peak,
               "rel_to_row": rel_row, "rel_to_row_limit": ATTN_RTOL[q.dtype]}
        if name.startswith("sq_gt_skv"):
            if not torch.equal(got[..., :sq - skv, :],
                               torch.zeros_like(got[..., :sq - skv, :])):
                raise AssertionError(f"flash_attention {name}: query rows "
                                     f"before every key must be exactly 0")
            row["rows_without_key_all_zero"] = True
        if timed:
            heads = q.numel() // (sq * d)
            pairs = attention_pairs(sq, skv, causal, window)
            flops = 4.0 * heads * pairs * d
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            b_ms, b_by = bound(flops, nbytes, q.dtype)
            library = sdpa_call(q, k, v, causal, window)
            _, lib_rel = errors(library().reshape(want.shape), want)
            row.update(
                ms=time_ms(lambda: ops.attention(q, k, v, **kw)),
                plain_ms=time_ms(lambda: A.flash_attention_plain(q, k, v,
                                                                 **kw)),
                library_ms=time_ms(library), library_rel_to_peak=lib_rel,
                bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
                visible_pairs_per_slice=pairs)
        rows.append(row)
        del want
    by_name = {r["name"]: r for r in rows}
    for name in ("decode_f32", "decode_bf16", "decode_f64"):
        if by_name[name]["splits"] < 2:
            raise AssertionError(f"{name} did not split: {by_name[name]}")
    combine = combine_case(cases, by_name["decode_bf16"])
    ratio = (by_name["mixtral_8x7b_window"]["ms"]
             / by_name["mixtral_8x7b_causal"]["ms"])
    pair_ratio = (by_name["mixtral_8x7b_window"]["visible_pairs_per_slice"]
                  / by_name["mixtral_8x7b_causal"]["visible_pairs_per_slice"])
    emit("attention", launches=counts, rows=rows, combine=combine,
         window_to_causal_ms_ratio=ratio,
         window_to_causal_pair_ratio=pair_ratio)
    timed = {("flash_attention_tc", "bfloat16"): by_name["qwen3_1.7b_prefill"],
             ("flash_attention", "float32"): by_name["decode_f32"],
             ("flash_attention", "float32 prefill"):
                 by_name["qwen3_1.7b_prefill_f32"],
             ("flash_attention", "float64"): by_name["decode_f64"],
             ("attn_combine", "bfloat16"): combine}
    return counts, timed


def combine_case(cases, decode) -> dict:
    """The combine kernel on the partials of the bf16 decode call (its
    blocks and splits), recomputed by ``split_partials_plain``, against its
    plain version; timed, with the bytes it must move as its bound (each
    partial read once, the output written once) and no library call that
    computes the same function."""
    _, q, k, v, causal, window, _ = next(c for c in cases
                                         if c[0] == decode["name"])
    part_o, part_ml = A.split_partials_plain(
        q, k, v, causal=causal, window=window, block_q=decode["blocks"][0],
        block_k=decode["blocks"][1], splits=decode["splits"])
    rows, width = part_o.shape[1:]
    out = torch.empty((rows, width), dtype=q.dtype, device=q.device)
    before = A.launch_counts()["attn_combine"]
    A.attn_combine(part_o, part_ml, out)
    torch.cuda.synchronize()
    if A.launch_counts()["attn_combine"] != before + 1:
        raise AssertionError("attn_combine did not launch its kernel")
    want = A.attn_combine_plain(part_o, part_ml, q.dtype)
    abs_err, rel_peak, rel_row = check_kernel(
        out, want, q.dtype, what="attn_combine decode_bf16", rtol=ATTN_RTOL,
        per_row=True)
    nbytes = (part_o.numel() + part_ml.numel()) * 4 \
        + out.numel() * out.element_size()
    b_ms, b_by = bound(0.0, nbytes, q.dtype)
    return {"name": "attn_combine", "dtype": str(q.dtype).removeprefix(
                "torch."),
            "shape": f"splits {decode['splits']} x {tuple(out.shape)}",
            "max_abs_err": abs_err, "rel_to_peak": rel_peak,
            "rel_to_row": rel_row,
            "ms": time_ms(lambda: A.attn_combine(part_o, part_ml, out)),
            "plain_ms": time_ms(lambda: A.attn_combine_plain(part_o, part_ml,
                                                             q.dtype)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def phase_tuning() -> None:
    """Measured sweeps into the (temporary) tuning cache, then the entry
    points under them: ``ops.attention`` given no blocks must launch the
    attention entry the cache holds; an A^96 chain at n = 512 runs on the
    tuned matmul tiles and squaring tiers and is held to ``error_budget``."""
    t0 = time.perf_counter()
    default_attn = ops.pick_attn_blocks(4096, 4096, 128, dtype=torch.bfloat16,
                                        use_cache=False)
    best_attn, attn_results = autotune.sweep_attention(
        4096, 4096, 128, torch.bfloat16)
    key = "attention/4096x4096x128/bfloat16/cuda"
    entry = autotune.load_cache()[key]
    if not entry["measured"] or tuple(entry["blocks"]) != best_attn:
        raise AssertionError(f"attention sweep recorded {entry}")
    # The heuristic alone launches default_attn, so a launch of the winner
    # shows the cache was read only where the two differ. Where they do not,
    # the best measured pair other than the default takes the entry's place.
    expect = best_attn
    if best_attn == default_attn:
        runner_up = next(r for r in attn_results
                         if r["blocks"] != default_attn
                         and r["score"] < float("inf"))
        expect = runner_up["blocks"]
        autotune.record(4096, 4096, 128, expect, dtype=torch.bfloat16,
                        backend="cuda", score=runner_up["score"],
                        measured=True, kernel="attention")

    rng = np.random.default_rng(60)
    q, k, v = (convert.from_reference(
        rng.standard_normal((16, 4096, 128), dtype=np.float32),
        dtype=torch.bfloat16) for _ in range(3))
    A.reset_launches()
    got = ops.attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    used = (A.last_launch["block_q"], A.last_launch["block_k"])
    if A.launch_counts()["flash_attention_tc"] != 1 or used != expect:
        raise AssertionError(f"ops.attention launched blocks {used} "
                             f"({A.launch_counts()}), the cache holds "
                             f"{expect}, the heuristic gives {default_attn}")
    check_kernel(got, A.flash_attention_plain(q, k, v, causal=True),
                 torch.bfloat16, what="ops.attention on tuned blocks",
                 rtol=ATTN_RTOL, per_row=True)
    del q, k, v, got

    default_mm = {n: ops.pick_blocks(n, n, n, dtype=torch.float32,
                                     use_cache=False) for n in (4096, 512)}
    mm = {n: autotune.sweep(n, n, n, torch.float32) for n in (4096, 512)}
    # Two unrecorded repeats of the tier sweep show whether it is stable.
    tier_repeats = [autotune.sweep_square_tiers(torch.float32, save=False)
                    for _ in range(2)]
    tiers = autotune.sweep_square_tiers(torch.float32)
    # The same for the tensor-core kernels: K1's tilings at 4096 bf16, and
    # whether K3 still beats K1 at the panel probe.
    default_tc = ops.pick_blocks(4096, 4096, 4096, dtype=torch.bfloat16,
                                 use_cache=False)
    mm_tc = autotune.sweep(4096, 4096, 4096, torch.bfloat16)
    tiers_tc = autotune.sweep_square_tiers(torch.bfloat16)
    # And for f64: K2 against K3 at 128^2, K3 against K1 at 256^2 (the
    # fp64 tensor-core kernels all three), then an A^96 f64 request on the
    # recorded limits.
    tiers_f64 = autotune.sweep_square_tiers(torch.float64)
    f64_chain = f64_tuned_chain(tiers_f64)

    n = 512
    chain = ops.MatmulChain(n, torch.float32, device="cuda")
    if chain.tiers != tiers or chain.blocks != mm[n][0]:
        raise AssertionError(f"chain took blocks {chain.blocks} tiers "
                             f"{chain.tiers}; the cache holds {mm[n][0]} "
                             f"{tiers}")
    a = power_operand(n, torch.float32, 61)
    want = f64_power(a, POWER, what="tuned chain")
    K.reset_launches()
    got = matpow_binary(a, POWER, backend="cuda_chain")
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    if sum(launches.values()) != MULTS or any(
            k.startswith("plain_") for k in launches):
        raise AssertionError(f"tuned chain launches {launches}")
    abs_err, rel_peak, rtol, atol = check_close(
        got, want, torch.float32, n=n, mults=MULTS,
        what=f"matpow_binary(n={n}, p={POWER}) on tuned tiles and tiers")
    emit("tuning", seconds=round(time.perf_counter() - t0, 2),
         attention={"shape": "16 x (4096, 4096, 128) bf16 causal",
                    "candidates": [list(c) for c in
                                   autotune.attn_candidates(torch.bfloat16)],
                    "default": list(default_attn), "winner": list(best_attn),
                    "scores_us": {str(r["blocks"]): r["score"]
                                  for r in attn_results},
                    "cache_entry_used": list(expect),
                    "runner_up_planted": expect != best_attn,
                    "launched": list(used)},
         matmul={str(n): {"default": list(default_mm[n]),
                          "winner": list(mm[n][0]),
                          "scores_us": {str(r["blocks"]): r["score"]
                                        for r in mm[n][1]}}
                 for n in mm},
         square_tiers={"default": list(autotune.DEFAULT_SQUARE_TIERS),
                       "recorded": list(tiers),
                       "repeats": [list(t) for t in tier_repeats],
                       "probes_us": autotune.load_cache()[
                           "square_panel/tiers/float32/cuda"]["probes_us"]},
         matmul_bf16_4096={"default": list(default_tc),
                           "winner": list(mm_tc[0]),
                           "scores_us": {str(r["blocks"]): r["score"]
                                         for r in mm_tc[1]}},
         square_tiers_bf16={"recorded": list(tiers_tc),
                            "probes_us": autotune.load_cache()[
                                "square_panel/tiers/bfloat16/cuda"][
                                "probes_us"]},
         square_tiers_f64={"default": list(autotune.DEFAULT_SQUARE_TIERS),
                           "recorded": list(tiers_f64),
                           "probes_us": autotune.load_cache()[
                               "square_panel/tiers/float64/cuda"][
                               "probes_us"],
                           "chain": f64_chain},
         chain={"n": n, "blocks": list(chain.blocks),
                "tiers": list(chain.tiers), "launches": launches,
                "max_abs_err_vs_f64": abs_err, "rel_to_peak_vs_f64": rel_peak,
                "rtol": rtol, "atol": atol})


def f64_tuned_chain(tiers) -> dict:
    """An A^96 f64 request at n = 256 on the squaring tiers just recorded:
    the chain must take them, launch seven kernels of the tier they give
    (no plain route) and hold ``error_budget(float64, n, 7)``."""
    n = 256
    chain = ops.MatmulChain(n, torch.float64, device="cuda")
    if chain.tiers != tiers:
        raise AssertionError(f"f64 chain took tiers {chain.tiers}; the cache "
                             f"holds {tiers}")
    a = power_operand(n, torch.float64, 62)
    want = f64_power(a, POWER, what="tuned f64 chain")
    K.reset_launches()
    got = matpow_binary(a, POWER, backend="cuda_chain")
    torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if v}
    if sum(launches.values()) != MULTS or any(
            k.startswith("plain_") for k in launches):
        raise AssertionError(f"tuned f64 chain launches {launches}")
    abs_err, rel_peak, rtol, atol = check_close(
        got, want, torch.float64, n=n, mults=MULTS,
        what=f"matpow_binary(n={n}, float64, p={POWER}) on tuned tiers")
    return {"n": n, "tiers": list(chain.tiers), "launches": launches,
            "max_abs_err_vs_f64": abs_err, "rel_to_peak_vs_f64": rel_peak,
            "rtol": rtol, "atol": atol}



# ---------------------------------------------------------------------------
# The serving engine (repro_torch.serve.matfn) and its driver
# ---------------------------------------------------------------------------

#: The serving mix: (op, dtype, n) classes, each matpow class at every power
#: of SERVE_POWERS. With the default thresholds (64, 4096) n = 64 takes the
#: "torch" route (cuBLAS) and the rest the kernel chain, through K2 / K3 / K1
#: in every dtype: f32 192 (K2), 512 and 1024 (K3), bf16 256 (K2) and 1024
#: (K3), f64 128 (K2) and 256 (K3), the combines on K1.
SERVE_CLASSES = ([("matpow", torch.float32, n) for n in (64, 192, 512, 1024)]
                 + [("matpow", torch.bfloat16, n) for n in (256, 1024)]
                 + [("matpow", torch.float64, n) for n in (128, 256)]
                 + [("expm", dt, n) for dt in (torch.float32, torch.float64)
                    for n in (64, 192)])
SERVE_POWERS = (7, 96)
SERVE_REQUESTS = 192
DAEMON_REQUESTS = 1024
DAEMON_PRODUCERS = 4
#: Phase serve_daemon's sustained runs: requests each, and offered load as
#: a fraction of the rate its overload run served.
SUSTAINED_REQUESTS = 512
SUSTAINED_LOADS = (0.5, 0.8)
ROUTE_BACKEND = {"torch": "torch", "chain": "cuda_chain"}
THETA13 = 5.371920351148152   # the Pade-13 1-norm threshold of core.expm


def serve_requests(count, seed):
    """``count`` requests cycling over the mix's classes, as (op, operand,
    power, float64 answer, multiplies): matpow operands are row-stochastic
    with distinct powers (``power_operand``), expm operands zero-mean
    normal with entries of size n^-1/2. The answer is the port's
    ``"torch"`` route in float64; ``mults`` counts the binary chain's
    multiplies, or expm's Pade-13 and solve (8) and its squarings."""
    classes = [(op, dt, n, p) for op, dt, n in SERVE_CLASSES
               for p in (SERVE_POWERS if op == "matpow" else (1,))]
    out = []
    for i in range(count):
        op, dt, n, p = classes[i % len(classes)]
        if op == "matpow":
            a = power_operand(n, dt, seed + i)
            want = matpow_binary(a.double(), p, backend="torch")
            mults = (p.bit_length() - 1) + (bin(p).count("1") - 1)
        else:
            a = randn((n, n), dt, seed + i, scale=n ** -0.5)
            want = expm(a.double(), backend="torch")
            norm = float(torch.linalg.matrix_norm(a.double(), ord=1))
            mults = 8 + max(0, math.ceil(math.log2(norm / THETA13)))
        out.append((op, a, p, want, mults))
    torch.cuda.synchronize()
    return out


def check_served(req, got, what):
    op, a, p, want, mults = req
    return check_close(got, want, a.dtype, n=a.shape[0], mults=mults,
                       what=f"{what} {op} n={a.shape[0]} {a.dtype} p={p}")[0]


def warm_classes(eng, reqs, batches) -> int:
    """Warm every class of ``reqs``; returns the chunks warmed (they count
    into the engine's ``buckets``)."""
    return sum(eng.warm(op, n, dtype=dtype, power=p,
                        batches=batches(op, n, dtype, p))
               for op, n, dtype, p in sorted({(op, a.shape[0], a.dtype, p)
                                              for op, a, p, *_ in reqs},
                                             key=str))


def phase_serve() -> tuple:
    """One engine on the card, warmed for every bucket of the mix, answers
    SERVE_REQUESTS requests in one synchronous flush. Every answer is held
    to float64; the chain buckets must launch every K1–K3 kernel (and no
    plain version); the flush's wall time stands beside a serial loop of
    per-request calls on the same routes."""
    reqs = serve_requests(SERVE_REQUESTS, 500)
    per_class = collections.Counter(
        (op, a.shape[0], a.dtype, p) for op, a, p, *_ in reqs)
    eng = MatFnEngine(device="cuda")
    warm_classes(eng, reqs, lambda *key: (per_class[key],))
    torch.cuda.synchronize()
    warm_stats = {k: eng.stats[k] for k in ("compiles", "cache_hits")}

    def flush():
        for op, a, p, *_ in reqs:
            eng.submit(op, a, power=p)
        return eng.flush()

    K.reset_launches()
    results = flush()
    counts = K.launch_counts()
    t0 = time.perf_counter()
    flush()                                    # timed: the second flush
    flush_ms = (time.perf_counter() - t0) * 1e3
    errs = [check_served(r, g, "serve") for r, g in zip(reqs, results)]
    missing = [k for k in K.KERNELS if counts[k] < 1]
    plain = {k: v for k, v in counts.items() if k.startswith("plain_") and v}
    if missing or plain:
        raise AssertionError(f"serve: chain buckets never launched {missing}"
                             f" or took the plain route {plain}: {counts}")

    def serial():
        for op, a, p, *_ in reqs:
            backend = ROUTE_BACKEND[eng.route_for(a.shape[0], 1, a.dtype)]
            if op == "matpow":
                matpow_binary(a, p, backend=backend)
            else:
                expm(a, backend=backend)
        torch.cuda.synchronize()

    serial()                                   # first calls out of the way
    t0 = time.perf_counter()
    serial()
    serial_ms = (time.perf_counter() - t0) * 1e3
    routes = {r: c for r, c in eng.stats["routes"].items() if c}
    emit("serve", requests=len(reqs), classes=len(per_class),
         buckets_by_route=routes, warm=warm_stats,
         compiles=eng.stats["compiles"], cache_hits=eng.stats["cache_hits"],
         launches={k: v for k, v in counts.items() if v},
         flush_ms=flush_ms, serial_ms=serial_ms,
         flush_req_per_s=len(reqs) / flush_ms * 1e3,
         serial_req_per_s=len(reqs) / serial_ms * 1e3,
         max_abs_err=max(errs))
    return reqs, len(reqs) / serial_ms * 1e3


def serve_same_bits(reqs) -> dict:
    """The same 64 requests through one stream and through the default
    streams: every answer must have the same bits (same callables, same
    inputs, same buckets: a ManualClock and one kick)."""
    outs = []
    for streams in (ExecutionStreams(streams=1), None):
        with MatFnEngine(device="cuda", streams=streams, clock=ManualClock(),
                         max_delay_ms=1e6) as eng:
            futs = [eng.submit(op, a, power=p) for op, a, p, *_ in reqs]
            eng.kick()
            outs.append([f.result(timeout=120) for f in futs])
            routes = {r: c for r, c in eng.stats["routes"].items() if c}
    diff = [i for i, (x, y) in enumerate(zip(*outs)) if not torch.equal(x, y)]
    if diff or set(routes) != {"torch", "chain"}:
        raise AssertionError(f"streams=1 and the default streams differ at "
                             f"requests {diff} (routes {routes})")
    return routes


def daemon_run(pool, count, rate, seed, *, trace):
    """One daemon with default streams, warmed for every bucket of the mix,
    offered ``count`` requests of ``pool`` open loop at ``rate`` requests a
    second by DAEMON_PRODUCERS threads, a quarter on the latency lane. Every
    future must resolve once with a verified value and nothing may be shed.
    Returns the closed engine, its ``stats()`` snapshot and a report: the
    offered and served rates, ``drain_ms`` (last resolution after the last
    submit, engine clock: near 0 while the daemon keeps up, the backlog's
    age when it does not), and p50 / p95 / p99 per lane."""
    rng = np.random.default_rng(seed)
    order = rng.integers(0, len(pool), count)
    lanes = np.where(rng.random(count) < 0.25, "latency", "bulk")
    eng = MatFnEngine(device="cuda", trace=trace)
    futs = [None] * count
    with eng:
        warmed = warm_classes(eng, pool,
                              lambda *key: (1, 2, 4, 8, 16, 32, 64))
        torch.cuda.synchronize()
        t_start = time.perf_counter()

        def producer(k):
            for i in range(k, count, DAEMON_PRODUCERS):
                delay = t_start + i / rate - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                op, a, p, *_ = pool[order[i]]
                futs[i] = eng.submit(op, a, power=p, priority=str(lanes[i]))

        threads = [threading.Thread(target=producer, args=(k,))
                   for k in range(DAEMON_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
            if t.is_alive():
                raise AssertionError("serve_daemon: a producer hung")
        results = [f.result(timeout=300) for f in futs]
        wall_s = time.perf_counter() - t_start
        snap = eng.stats()
        p99 = {lane: eng.metrics.merged("latency", lane=lane).quantile(0.99)
               * 1e3 for lane in ("bulk", "latency")}
    errs = [check_served(pool[order[i]], g, "serve_daemon")
            for i, g in enumerate(results)]
    flushed = sum(row["flushed"] for row in snap["lanes"].values())
    shed = sum(row["shed"] for row in snap["lanes"].values())
    if snap["requests"] != count or flushed != count or shed:
        raise AssertionError(f"serve_daemon: {snap['requests']} admitted, "
                             f"{flushed} flushed, {shed} shed")
    drain_s = max(f.resolved_at for f in futs) - max(f.submitted_at
                                                     for f in futs)
    report = dict(
        requests=count, offered_req_per_s=rate,
        served_req_per_s=count / wall_s, wall_s=wall_s,
        drain_ms=drain_s * 1e3,
        lanes={lane: {"submitted": row["submitted"], "p50_ms": row["p50_ms"],
                      "p95_ms": row["p95_ms"], "p99_ms": p99[lane]}
               for lane, row in snap["lanes"].items()},
        flush_triggers=snap["flush_triggers"],
        buckets=snap["buckets"] - warmed,
        stragglers=snap["stragglers"], retries=snap["retries"], shed=shed,
        max_abs_err=max(errs))
    return eng, snap, report


def phase_serve_daemon(pool, capacity) -> None:
    """The daemon under open-loop load, in two settings. Overload:
    DAEMON_REQUESTS requests of the mix at 1.5x the serial capacity phase
    serve measured, traced; the Chrome trace must parse with spans on every
    stream that served, and the stream count must not change a bit. Its
    latencies are a backlog's age, not a serving latency. Sustained: fewer
    requests at each of SUSTAINED_LOADS times the rate the overload run
    served, untraced; their per-lane latencies are the serving metric."""
    K.reset_launches()
    eng, snap, overload = daemon_run(pool, DAEMON_REQUESTS, 1.5 * capacity,
                                     501, trace=True)
    counts = K.launch_counts()
    # host ms per bucket and stage (engine clock), and per route for the
    # execute stage (the launches; expm's own syncs included)
    stages = {stage: {"count": h["count"], "mean_ms": h["mean"] * 1e3,
                      "p50_ms": h["p50"] * 1e3, "p95_ms": h["p95"] * 1e3}
              for stage, h in snap["stages"].items()}
    for route in ("torch", "chain"):
        h = eng.metrics.merged("stage", stage="execute", route=route)
        stages[f"execute_{route}"] = {"count": h.count,
                                      "mean_ms": None if h.mean is None
                                      else h.mean * 1e3}
    trace_path = Path(tempfile.mkdtemp(prefix="chip-smoke-trace-")) / "t.json"
    eng.tracer.export(trace_path)
    doc = json.loads(trace_path.read_text())
    shutil.rmtree(trace_path.parent, ignore_errors=True)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M"}
    served = [row for row in snap["streams"] if row["executed"]]
    untraced = [row["label"] for row in served
                if f"stream-{row['stream']}" not in tracks
                or not any(row["label"] in t for t in tracks)]
    if untraced or len(served) < 2:
        raise AssertionError(f"serve_daemon: streams {untraced} have no "
                             f"spans in the trace ({sorted(tracks)})")
    same_bits_routes = serve_same_bits(pool[:64])
    emit("serve_daemon", load="overload", producers=DAEMON_PRODUCERS,
         **overload, peak_concurrent_streams=snap["peak_concurrent_streams"],
         streams={row["label"]: row["executed"] for row in served},
         trace_events=len(doc["traceEvents"]),
         launches={k: v for k, v in counts.items() if v},
         stages=stages, same_bits_routes=same_bits_routes)
    for k, factor in enumerate(SUSTAINED_LOADS):
        rate = factor * overload["served_req_per_s"]
        _, _, report = daemon_run(pool, SUSTAINED_REQUESTS, rate, 502 + k,
                                  trace=False)
        emit("serve_daemon", load="sustained", of_overload_served=factor,
             **report)


def phase_matserve() -> None:
    """The port's serving driver as a user starts it, on the card."""
    argv = ["--daemon", "--rate", "2000", "--requests", "256", "--sizes",
            "64,192,512", "--powers", "7,96", "--dtypes", "float32,float64",
            "--verify"]
    t0 = time.perf_counter()
    rc = matserve.main(argv)
    if rc != 0:
        raise AssertionError(f"matserve {' '.join(argv)} returned {rc}")
    emit("matserve", argv=argv, rc=rc,
         seconds=round(time.perf_counter() - t0, 2))


def phase_dispatch() -> None:
    """Measurement only: one (B, n, n) f32 bucket at p = 96 through the
    "torch" route and the kernel chain — device ms (CUDA-graph replays) and
    host ms (one call ending in a synchronise) — the sizes at which the
    chain wins, and the smallest n from which the "torch" route wins at
    every larger size measured. ``DEFAULT_DISPATCH_THRESHOLDS`` is not
    changed."""
    rows, crossover = [], {}
    for batch in (1, 16):
        for n in (32, 64, 128, 256, 512, 1024):
            a = power_operand(n, torch.float32, 600 + n, batch=batch)
            row = {"batch": batch, "n": n}
            for route, backend in ROUTE_BACKEND.items():
                fn = (lambda b=backend: batched_matpow(a, POWER, backend=b))
                row[f"{route}_device_ms"] = time_ms(fn)
                row[f"{route}_host_ms"] = wall_ms(fn)
            rows.append(row)
        for kind in ("device", "host"):
            mine = [r for r in rows if r["batch"] == batch]
            chain = [r["n"] for r in mine
                     if r[f"chain_{kind}_ms"] < r[f"torch_{kind}_ms"]]
            torch_from = None
            for r in reversed(mine):
                if r["n"] in chain:
                    break
                torch_from = r["n"]
            crossover[f"B{batch}_{kind}"] = {"chain_wins_at": chain,
                                             "torch_wins_from": torch_from}
    emit("dispatch", power=POWER, dtype="float32", rows=rows,
         crossover=crossover,
         thresholds=list(autotune.DEFAULT_DISPATCH_THRESHOLDS))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cache_dir = tempfile.mkdtemp(prefix="chip-smoke-autotune-")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(cache_dir) / "autotune_torch.json")
    autotune.clear_memory_cache()
    try:
        smi = phase_device()
        phase_build()
        timed = phase_kernels()
        counts, _ = phase_matpow()
        phase_entry_points()
        phase_batched()
        t_serve = time.perf_counter()
        pool, capacity = phase_serve()
        phase_serve_daemon(pool, capacity)
        phase_matserve()
        phase_dispatch()
        emit("serving_phases", seconds=round(time.perf_counter() - t_serve,
                                             1))
        attn_counts, attn_timed = phase_attention()
        phase_tuning()
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    counts = {**counts, **attn_counts}
    timed = {**timed, **attn_timed}
    kernels = []
    for name, label in KERNEL_ROWS:
        row = timed[(name, label)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "dtype": row["dtype"]})
    emit("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
