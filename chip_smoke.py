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
chain; the Strassen route (``kernels.fastmm``: every leaf a K1 launch,
7^L a multiply, against the dense squaring, ``torch.matmul`` and float64;
A^96 on ``"cuda_fastmm"``; the crossover ``sweep_fastmm`` measures) and the
Markov workloads (``steady_state`` with the bits of the chain,
``evolve_distributions`` on K1 against one dense power and one apply); the
serving engine with matpow, expm, markov and evolve traffic on its
``torch``, ``chain``, ``fastmm`` and ``evolve`` routes, and its driver;
and the sharded chain (``core.distributed``: ``matpow_sharded`` at n = 4096
in f32, bf16 and f64 with each schedule, ``expm_sharded``, the engine's
``sharded`` route) on a world-1 NCCL group's 1x1 mesh, every local
product a K1 launch; and the LM serving path (``serve.engine.generate`` for
Qwen3-1.7B and Mamba2-130m at full width and depth and the other eight
configs at published widths, every projection a K1 launch, counted per
prefill and per decode step; K1 at the LM's shapes against its plain
version; a 2-layer Qwen3-1.7B on the card against the CPU; Mixtral's ring
cache); and the LM training path (``launch.train.build``'s step on
``SyntheticStream`` batches for Qwen3-1.7B and Mamba2-130m at full width
and depth, every projection K1 in the forward, in the remat recomputation
and in both backward products, counted exactly per step; K1 at the
backward shapes against its plain version; a 2-layer Qwen3-1.7B step on
the card against the CPU; checkpoint save, restore and resume on the
card); and the dry run (``launch.dryrun``'s counts of that Qwen3-1.7B
step, made on meta tensors in a child process, against the same step on
the card: FLOPs, ``dense_mm`` calls, peak memory, the roofline terms
beside the measured ms).
Each phase prints one JSON line; any
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
from repro_torch.core import (batched_expm, batched_matpow,  # noqa: E402
                              evolve_distributions, expm, expm_sharded,
                              markov_power, matpow_binary,
                              matpow_binary_traced, matpow_naive,
                              matpow_sharded, steady_state)
from repro_torch.kernels import (_build, autotune, error_budget,  # noqa: E402
                                 fastmm, ops, ref)
from repro_torch.kernels import attention_kernels as A  # noqa: E402
from repro_torch.kernels import matmul_kernels as K  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.data.synthetic import (SyntheticStream,  # noqa: E402
                                        make_batch)
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)
from repro_torch import models as models_lib  # noqa: E402
from repro_torch.launch import matserve  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.collectives import (compressed_psum,  # noqa: E402
                                              dequantize_int8, ef_compress,
                                              quantize_int8)
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


def check_close(got, want, dtype, *, n, mults=1, levels=0, what) -> tuple:
    """Hold ``got`` to ``want`` under ``error_budget(dtype, levels, n,
    mults)``, elementwise, and — because the budget's absolute floor is
    loose for small-valued results — also hold the peak-relative error to
    its rtol (``levels`` Strassen levels widen both)."""
    rtol, atol = error_budget(dtype, levels=levels, n=n, mults=mults)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values in the result")
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    abs_err, rel_peak = errors(got, want)
    ok = torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol)
    floor_rtol = error_budget(dtype, levels=levels)[0]
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
# The Strassen route (kernels.fastmm) and the Markov workloads (core.markov)
# ---------------------------------------------------------------------------

#: strassen_square's cases: (n, dtype) at levels 1 and 2, on a crossover low
#: enough that the depth cap alone stops the recursion. n = 2049 pads one
#: row and column at the top level (and at the second).
STRASSEN_CASES = ([(n, dt) for n in (2048, 4096)
                   for dt in (torch.float32, torch.bfloat16, torch.float64)]
                  + [(2049, torch.float32)])
STRASSEN_CROSSOVER = 256
#: A^96 on "cuda_fastmm" beside "cuda_chain" and "torch": n, in f32 and f64.
STRASSEN_MATPOW_N = 4096
#: The candidate crossovers ``sweep_fastmm`` probes (at twice each).
SWEEP_CANDIDATES = (256, 512, 1024, 2048)


def launch_delta(fn):
    """(result, launches added by ``fn()``, peak bytes allocated above what
    was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = K.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = K.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return out, delta, torch.cuda.max_memory_allocated() - base


def strassen_case(n, dtype, levels, seed) -> dict:
    """One strassen_square: exactly 7^L launches of the dtype's K1 and
    nothing else, within ``error_budget(levels=L)`` of the float64 square;
    its device ms beside the dense squaring (``ops.square``, K1 at these
    sizes) and ``torch.matmul``."""
    what = f"strassen_square(n={n}, {dtype}, levels={levels})"
    a = randn((n, n), dtype, seed)
    used = fastmm.plan_levels(n, levels, STRASSEN_CROSSOVER)
    if used != levels:
        raise AssertionError(f"{what}: recursion plans {used} levels")
    fn = (lambda: fastmm.strassen_square(a, levels=levels,
                                         crossover=STRASSEN_CROSSOVER))
    got, delta, peak = launch_delta(fn)
    k1 = K.kernel_name("matmul", dtype)
    if delta != {k1: 7 ** levels}:
        raise AssertionError(f"{what}: launches {delta}, expected "
                             f"{{{k1!r}: {7 ** levels}}}")
    a64 = a.double()
    want = a64 @ a64
    err = check_close(got, want, dtype, n=n, levels=levels,
                      what=what + " vs float64")
    dense = ops.square(a)
    repro_torch.exact_matmul_settings()
    library = torch.matmul(a, a)
    row = {"n": n, "dtype": str(dtype).removeprefix("torch."),
           "levels": levels, "launches": delta, "peak_mb": peak / 2 ** 20,
           "max_abs_err_vs_f64": err[0], "rel_to_peak_vs_f64": err[1],
           "rtol": err[2], "atol": err[3],
           "max_abs_err_vs_dense": errors(got, dense)[0],
           "max_abs_err_vs_torch_matmul": errors(got, library)[0]}
    del got, want, a64, dense, library
    row["strassen_ms"] = time_ms(fn)
    row["dense_ms"] = time_ms(lambda: ops.square(a))
    row["torch_matmul_ms"] = time_ms(lambda: torch.matmul(a, a))
    return row


def phase_strassen() -> None:
    """The Strassen route: ``strassen_square`` at levels 1 and 2
    (STRASSEN_CASES); A^96 on ``"cuda_fastmm"`` at n = 4096 f32 and f64
    beside ``"cuda_chain"`` and ``"torch"``; then ``sweep_fastmm`` into a
    tuning cache of its own (measurement only: the default crossover is not
    changed)."""
    rows = [strassen_case(n, dt, levels, 800 + i)
            for i, (n, dt) in enumerate(STRASSEN_CASES)
            for levels in (1, 2)]
    chains = []
    for dtype, seed in ((torch.float32, 820), (torch.float64, 821)):
        n = STRASSEN_MATPOW_N
        what = f"matpow_binary(n={n}, {dtype}, p={POWER}, cuda_fastmm)"
        a = power_operand(n, dtype, seed)
        chain = ops.MatmulChain(n, dtype, device="cuda", fast=True)
        levels = chain.fast_levels
        got, delta, peak = launch_delta(
            lambda: matpow_binary(a, POWER, backend="cuda_fastmm"))
        k1 = K.kernel_name("matmul", dtype)
        if delta != {k1: MULTS * 7 ** levels}:
            raise AssertionError(f"{what}: launches {delta}")
        want = f64_power(a, POWER, what=what)
        err = check_close(got, want, dtype, n=n, mults=MULTS, levels=levels,
                          what=what + " vs float64")
        del got, want
        chains.append({
            "n": n, "dtype": str(dtype).removeprefix("torch."),
            "levels": levels, "launches": delta, "peak_mb": peak / 2 ** 20,
            "max_abs_err_vs_f64": err[0], "rel_to_peak_vs_f64": err[1],
            "rtol": err[2],
            "cuda_fastmm_ms": wall_ms(
                lambda: matpow_binary(a, POWER, backend="cuda_fastmm")),
            "cuda_chain_ms": wall_ms(
                lambda: matpow_binary(a, POWER, backend="cuda_chain")),
            "torch_ms": wall_ms(
                lambda: matpow_binary(a, POWER, backend="torch"))})
    # The sweep records into a cache of its own, so the later phases keep
    # the default crossover.
    main_cache = os.environ["REPRO_TORCH_AUTOTUNE_CACHE"]
    sweep_dir = tempfile.mkdtemp(prefix="chip-smoke-fastmm-")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        Path(sweep_dir) / "autotune_torch.json")
    autotune.clear_memory_cache()
    try:
        crossover, levels = autotune.sweep_fastmm(
            torch.float32, measure=True, candidates=SWEEP_CANDIDATES)
        entry = autotune.load_cache()[autotune._fastmm_key(torch.float32)]
    finally:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = main_cache
        autotune.clear_memory_cache()
        shutil.rmtree(sweep_dir, ignore_errors=True)
    if autotune.fastmm_config(torch.float32)[0] != \
            autotune.DEFAULT_FASTMM_CROSSOVER:
        raise AssertionError("the sweep's entry leaked into the main cache")
    emit("strassen", crossover=STRASSEN_CROSSOVER, rows=rows, matpow=chains,
         sweep={"crossover": crossover, "levels": levels,
                "measured": entry["measured"],
                "probes_us": entry.get("probes_us"),
                "default": autotune.DEFAULT_FASTMM_CROSSOVER})


def stochastic(n, dtype, seed):
    """A well-mixed random chain: rows of uniform(0.05, 1.05) entries, each
    divided by its sum, from a numpy seed."""
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) + 0.05
    return convert.from_reference(m / m.sum(axis=-1, keepdims=True),
                                  dtype=dtype)


MARKOV_TOL = 1e-6
#: steady_state's (n, dtype) cases; n = 1000 pads to 1024 on the chain.
STEADY_CASES = ((2048, torch.float64), (1000, torch.float32))
#: evolve_distributions at n = EVOLVE_N over EVOLVE_STEPS steps for each B:
#: B <= n runs the evolve loop, B > n the dense fallback.
EVOLVE_N = 1024
EVOLVE_BS = (1, 256, 2048)
EVOLVE_STEPS = 10_000


def steady_case(n, dtype, seed) -> dict:
    """``steady_state`` on ``"cuda_chain"``: converges in under 20
    squarings to a residual within ``MARKOV_TOL``; its pi is a fixed point
    (‖π·P − π‖₁ in float64 within the loop's tol plus the dtype's rtol);
    its matrix has the bits of ``matpow_binary(p, 2**k)`` on the same
    route; timed beside the fixed p = 2^20 policy."""
    what = f"steady_state(n={n}, {dtype}, cuda_chain)"
    p = stochastic(n, dtype, seed)
    res, delta, peak = launch_delta(
        lambda: steady_state(p, tol=MARKOV_TOL, backend="cuda_chain",
                             validate=False))
    k = int(res.squarings)
    if not 0 < k < 20 or float(res.residual) > MARKOV_TOL:
        raise AssertionError(f"{what}: {k} squarings, residual "
                             f"{float(res.residual):.3e}")
    if any(key.startswith("plain") for key in delta):
        raise AssertionError(f"{what}: plain route {delta}")
    drift = float((res.pi.double() @ p.double() - res.pi.double())
                  .abs().sum())
    limit = MARKOV_TOL + error_budget(dtype, n=n, mults=k)[0]
    if not drift <= limit:
        raise AssertionError(f"{what}: |pi P - pi|_1 = {drift:.3e} > "
                             f"{limit:.3e}")
    same = torch.equal(res.matrix,
                       matpow_binary(p, 1 << k, backend="cuda_chain"))
    if not same:
        raise AssertionError(f"{what}: matrix differs from "
                             f"matpow_binary(p, 2**{k}) on cuda_chain")
    return {"n": n, "dtype": str(dtype).removeprefix("torch."),
            "squarings": k, "residual": float(res.residual),
            "pi_drift_l1": drift, "drift_limit": limit,
            "bits_of_matpow": same, "launches": delta,
            "peak_mb": peak / 2 ** 20,
            "steady_ms": wall_ms(lambda: steady_state(
                p, tol=MARKOV_TOL, backend="cuda_chain", validate=False)),
            "fixed_2_20_ms": wall_ms(lambda: matpow_binary(
                p, 1 << 20, backend="cuda_chain"))}


def evolve_case(n, b, seed) -> dict:
    """``evolve_distributions`` of B distributions over EVOLVE_STEPS
    steps (the evolve loop while B <= n, the dense fallback above) against
    float64 P^steps applied once; K1 launches of its vector–matrix
    products, the rows K1 padded B to, and its ms beside ``markov_power``
    and one apply."""
    dtype = torch.float32
    what = f"evolve_distributions(n={n}, B={b}, steps={EVOLVE_STEPS})"
    p = stochastic(n, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    d = rng.random((b, n))
    d = convert.from_reference(d / d.sum(axis=1, keepdims=True), dtype=dtype)
    route = "evolve" if b <= autotune.markov_evolve_threshold(dtype) * n \
        else "dense"
    got, delta, peak = launch_delta(lambda: evolve_distributions(
        d, p, EVOLVE_STEPS, backend="cuda_chain", validate=False))
    bits = EVOLVE_STEPS.bit_length() - 1
    ones = bin(EVOLVE_STEPS).count("1")
    # A squaring per remaining bit (K2 / K3, or K1 where the tier policy
    # sends the size to it) and popcount K1 launches: a product per set bit
    # (evolve), or the power's combines and one apply (dense).
    if sum(delta.values()) != bits + ones or \
            delta.get("matmul", 0) < ones or \
            any(key.startswith("plain") for key in delta):
        raise AssertionError(f"{what}: launches {delta}")
    # The product itself is one K1 launch, never a plain version.
    _, one, _ = launch_delta(lambda: ops.dense_matmul(d, p))
    if one != {"matmul": 1}:
        raise AssertionError(f"{what}: dense_matmul launched {one}")
    want = d.double() @ torch.linalg.matrix_power(p.double(), EVOLVE_STEPS)
    err = check_close(got, want, dtype, n=n, mults=bits + ones,
                      what=what + " vs float64")
    bm = ops.pick_blocks(b, n, n, dtype=dtype, backend="cuda")[0]

    def dense():
        m = markov_power(p, EVOLVE_STEPS, backend="cuda_chain",
                         validate=False)
        return ops.dense_matmul(d, m)

    return {"n": n, "B": b, "steps": EVOLVE_STEPS, "route": route,
            "launches": delta, "k1_rows": -(-b // bm) * bm,
            "peak_mb": peak / 2 ** 20, "max_abs_err_vs_f64": err[0],
            "rel_to_peak_vs_f64": err[1],
            "evolve_ms": wall_ms(lambda: evolve_distributions(
                d, p, EVOLVE_STEPS, backend="cuda_chain", validate=False)),
            "markov_power_and_apply_ms": wall_ms(dense)}


def phase_markov() -> None:
    """The Markov workloads on the card: steady states at n = 2048 f64 and
    n = 1000 f32 (padded to 1024 by the chain), and distribution evolution
    at n = 1024 f32 for B = 1 and 256 (the evolve loop) and 2048 (the dense
    fallback)."""
    steady = [steady_case(n, dt, 830 + i)
              for i, (n, dt) in enumerate(STEADY_CASES)]
    evolve = [evolve_case(EVOLVE_N, b, 840 + b) for b in EVOLVE_BS]
    emit("markov", tol=MARKOV_TOL, steady=steady, evolve=evolve)


# ---------------------------------------------------------------------------
# The serving engine (repro_torch.serve.matfn) and its driver
# ---------------------------------------------------------------------------

#: The serving mix: (op, dtype, n) classes, each matpow class at every power
#: of SERVE_POWERS. With the default thresholds (64, 4096) n = 64 takes the
#: "torch" route (cuBLAS) and the rest up to 1024 the kernel chain, through
#: K2 / K3 / K1 in every dtype: f32 192 (K2), 512 and 1024 (K3), bf16 256
#: (K2) and 1024 (K3), f64 128 (K2) and 256 (K3), the combines on K1. n =
#: 2048 (matpow, expm) is above the default Strassen crossover: the
#: "fastmm" route, K1 leaves. "markov" is a steady-state query on the chain,
#: "evolve" a markov request with EVOLVE_B distributions over EVOLVE_HORIZON
#: steps, on the evolve route.
SERVE_CLASSES = ([("matpow", torch.float32, n)
                  for n in (64, 192, 512, 1024, 2048)]
                 + [("matpow", torch.bfloat16, n) for n in (256, 1024)]
                 + [("matpow", torch.float64, n) for n in (128, 256)]
                 + [("expm", dt, n) for dt in (torch.float32, torch.float64)
                    for n in (64, 192)]
                 + [("expm", torch.float32, 2048),
                    ("markov", torch.float32, 256),
                    ("evolve", torch.float32, 256)])
SERVE_POWERS = (7, 96)
EVOLVE_B = 16
EVOLVE_HORIZON = 100
SERVE_REQUESTS = 192
DAEMON_REQUESTS = 1024
DAEMON_PRODUCERS = 4
#: Phase serve_daemon's sustained runs: requests each, and offered load as
#: a fraction of the rate its overload run served.
SUSTAINED_REQUESTS = 512
SUSTAINED_LOADS = (0.5, 0.8)
ROUTE_BACKEND = {"torch": "torch", "chain": "cuda_chain",
                 "fastmm": "cuda_fastmm"}
THETA13 = 5.371920351148152   # the Pade-13 1-norm threshold of core.expm


def route_levels(n, dtype) -> int:
    """Strassen levels of an n-sized request's bucket on the default
    config: those of a ``fast=None`` chain (0 at or below the crossover)."""
    return ops.MatmulChain(n, dtype, device="cuda", fast=None).fast_levels


def serve_requests(count, seed):
    """``count`` requests cycling over the mix's classes, as (op, operand,
    power, float64 answer, multiplies, Strassen levels, dists): matpow
    operands are row-stochastic with distinct powers (``power_operand``),
    expm operands zero-mean normal with entries of size n^-1/2, markov
    operands well-mixed random chains (``stochastic``). The answer is the
    port's ``"torch"`` route in float64 (a steady state's pi, an evolved
    stack); ``mults`` counts the binary chain's multiplies, expm's Pade-13
    and solve (8) and its squarings, an evolve request's squarings and
    products (a steady state's are read from its answer); ``levels`` is the
    fastmm route's depth at n (0 on the other routes)."""
    classes = [(op, dt, n, p) for op, dt, n in SERVE_CLASSES
               for p in (SERVE_POWERS if op == "matpow"
                         else (EVOLVE_HORIZON,) if op == "evolve" else (1,))]
    out = []
    for i in range(count):
        op, dt, n, p = classes[i % len(classes)]
        dists, levels = None, route_levels(n, dt)
        if op == "matpow":
            a = power_operand(n, dt, seed + i)
            want = matpow_binary(a.double(), p, backend="torch")
            mults = (p.bit_length() - 1) + (bin(p).count("1") - 1)
        elif op == "expm":
            a = randn((n, n), dt, seed + i, scale=n ** -0.5)
            want = expm(a.double(), backend="torch")
            norm = float(torch.linalg.matrix_norm(a.double(), ord=1))
            mults = 8 + max(0, math.ceil(math.log2(norm / THETA13)))
        elif op == "markov":
            a = stochastic(n, dt, seed + i)
            want = steady_state(a.double(), validate=False).pi
            mults = None
        else:
            op, levels = "markov", 0
            a = stochastic(n, dt, seed + i)
            rng = np.random.default_rng(seed + i)
            d = rng.random((EVOLVE_B, n))
            dists = convert.from_reference(d / d.sum(axis=1, keepdims=True),
                                           dtype=dt)
            want = evolve_distributions(dists.double(), a.double(), p,
                                        validate=False)
            mults = (p.bit_length() - 1) + bin(p).count("1")
        out.append((op, a, p, want, mults, levels, dists))
    torch.cuda.synchronize()
    return out


def submit(eng, req, **kw):
    """Submit one request of ``serve_requests`` to ``eng``."""
    op, a, p, *_, dists = req
    return eng.submit(op, a, power=p, dists=dists, **kw)




def same_bits(x, y) -> bool:
    """Bit equality of two served answers (a steady state field by
    field)."""
    if isinstance(x, tuple):
        return all(torch.equal(u, v) for u, v in zip(x, y))
    return torch.equal(x, y)


def check_served(req, got, what):
    """Hold one served answer to its float64 answer; a steady state by its
    pi, with the squarings it paid as its multiplies."""
    op, a, p, want, mults, levels, dists = req
    kind = "evolve" if dists is not None else op
    if isinstance(got, tuple):
        mults = max(int(got.squarings), 1)
        got = got.pi
    return check_close(got, want, a.dtype, n=a.shape[0],
                       mults=mults, levels=levels,
                       what=f"{what} {kind} n={a.shape[0]} {a.dtype} "
                            f"p={p}")[0]


def warm_classes(eng, reqs, batches) -> int:
    """Warm every class of ``reqs`` (evolve classes have no warm); returns
    the chunks warmed (they count into the engine's ``buckets``)."""
    return sum(eng.warm(op, n, dtype=dtype, power=p,
                        batches=batches(op, n, dtype, p))
               for op, n, dtype, p in sorted(
                   {(op, a.shape[0], a.dtype, p)
                    for op, a, p, *_, dists in reqs if dists is None},
                   key=str))


def phase_serve() -> tuple:
    """One engine on the card, warmed for every bucket of the mix, answers
    SERVE_REQUESTS requests in one synchronous flush. Every answer is held
    to float64 (fastmm answers under their levels' budget); the chain
    buckets must launch every K1–K3 kernel (and no plain version), the
    flush must have buckets on the torch, chain, fastmm and evolve routes,
    and a flush of the fastmm requests alone must launch K1 only; the
    flush's wall time stands beside a serial loop of per-request calls on
    the same routes."""
    reqs = serve_requests(SERVE_REQUESTS, 500)
    per_class = collections.Counter(
        (op, a.shape[0], a.dtype, p) for op, a, p, *_ in reqs)
    eng = MatFnEngine(device="cuda")
    warm_classes(eng, reqs, lambda *key: (per_class[key],))
    torch.cuda.synchronize()
    warm_stats = {k: eng.stats[k] for k in ("compiles", "cache_hits")}

    def flush(batch=reqs):
        for req in batch:
            submit(eng, req)
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
    served_routes = {r for r, c in eng.stats["routes"].items() if c}
    if not {"torch", "chain", "fastmm", "evolve"} <= served_routes:
        raise AssertionError(f"serve: buckets on routes {served_routes}")
    fast = [r for r in reqs if r[6] is None
            and eng.route_for(r[1].shape[0], 1, r[1].dtype) == "fastmm"]
    K.reset_launches()
    fast_results = flush(fast)
    fast_counts = {k: v for k, v in K.launch_counts().items() if v}
    if set(fast_counts) != {"matmul"} or fast_counts["matmul"] < 7:
        raise AssertionError(f"serve: the fastmm buckets launched "
                             f"{fast_counts}, not K1 alone")
    errs += [check_served(r, g, "serve fastmm")
             for r, g in zip(fast, fast_results)]

    def serial():
        for op, a, p, *_, dists in reqs:
            n = a.shape[0]
            if dists is not None:
                backend = "torch" if n <= eng.thresholds_for(a.dtype)[0] \
                    else "cuda_chain"
                evolve_distributions(dists, a, p, backend=backend,
                                     validate=False)
                continue
            backend = ROUTE_BACKEND[eng.route_for(n, 1, a.dtype)]
            if op == "matpow":
                matpow_binary(a, p, backend=backend)
            elif op == "expm":
                expm(a, backend=backend)
            else:
                steady_state(a, backend=backend, validate=False)
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
         fastmm_requests=len(fast), fastmm_launches=fast_counts,
         flush_ms=flush_ms, serial_ms=serial_ms,
         flush_req_per_s=len(reqs) / flush_ms * 1e3,
         serial_req_per_s=len(reqs) / serial_ms * 1e3,
         max_abs_err=max(errs))
    return reqs, len(reqs) / serial_ms * 1e3


def serve_same_bits(reqs) -> dict:
    """The same 64 requests (every class of the mix) through one stream
    and through the default streams: every answer must have the same bits
    (same callables, same inputs, same buckets: a ManualClock and one
    kick), on all four served routes."""
    outs = []
    for streams in (ExecutionStreams(streams=1), None):
        with MatFnEngine(device="cuda", streams=streams, clock=ManualClock(),
                         max_delay_ms=1e6) as eng:
            futs = [submit(eng, req) for req in reqs]
            eng.kick()
            outs.append([f.result(timeout=120) for f in futs])
            routes = {r: c for r, c in eng.stats["routes"].items() if c}
    diff = [i for i, (x, y) in enumerate(zip(*outs)) if not same_bits(x, y)]
    if diff or set(routes) != {"torch", "chain", "fastmm", "evolve"}:
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
        # Above the Strassen crossover a 64-deep warm stack would take
        # seconds; the mix's few requests there fill small buckets.
        warmed = warm_classes(
            eng, pool, lambda op, n, dtype, p: (1, 2, 4, 8)
            if n > autotune.DEFAULT_FASTMM_CROSSOVER
            else (1, 2, 4, 8, 16, 32, 64))
        torch.cuda.synchronize()
        t_start = time.perf_counter()

        def producer(k):
            for i in range(k, count, DAEMON_PRODUCERS):
                delay = t_start + i / rate - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futs[i] = submit(eng, pool[order[i]],
                                 priority=str(lanes[i]))

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
    routes = {r: c for r, c in snap["routes"].items() if c}
    if not {"torch", "chain", "fastmm", "evolve"} <= set(routes):
        raise AssertionError(f"serve_daemon: buckets on routes {routes}")
    for route in ("torch", "chain", "fastmm", "evolve"):
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
         buckets_by_route=routes,
         stages=stages, same_bits_routes=same_bits_routes)
    for k, factor in enumerate(SUSTAINED_LOADS):
        rate = factor * overload["served_req_per_s"]
        _, _, report = daemon_run(pool, SUSTAINED_REQUESTS, rate, 502 + k,
                                  trace=False)
        emit("serve_daemon", load="sustained", of_overload_served=factor,
             **report)


MATSERVE_ARGV = ["--daemon", "--rate", "1000", "--requests", "256",
                 "--sizes", "64,192,512,2048", "--powers", "7,96",
                 "--dtypes", "float32,float64", "--markov-frac", "0.25",
                 "--verify"]


def phase_matserve() -> None:
    """The port's serving driver as a user starts it, on the card, with a
    quarter of markov traffic and n = 2048 on the fastmm route."""
    argv = MATSERVE_ARGV
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
            for route in ("torch", "chain"):
                backend = ROUTE_BACKEND[route]
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


# ---------------------------------------------------------------------------
# The sharded chain (repro_torch.core.distributed) on a 1x1 NCCL mesh
# ---------------------------------------------------------------------------

SHARDED_N = 4096
SHARDED_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
#: expm_sharded's operand: normal entries at this scale give |A|_1 near 65
#: at n = 4096, so s = 4 squarings run on the mesh.
SHARDED_EXPM_SCALE = 0.02


def sharded_case(mesh, dtype, seed) -> list:
    """``matpow_sharded(a, 96)`` at n = 4096 with each schedule forced:
    exactly MULTS launches of the dtype's K1 and nothing else, within
    ``error_budget(mults=7)`` of the float64 power; host ms beside the
    single-device chain's."""
    a = power_operand(SHARDED_N, dtype, seed)
    name = str(dtype).removeprefix("torch.")
    want = f64_power(a, POWER, what=f"matpow_sharded(n={SHARDED_N}, {name})")
    k1 = K.kernel_name("matmul", dtype)
    chain_ms = wall_ms(lambda: matpow_binary(a, POWER, backend="cuda_chain"))
    rows = []
    for alg in ("gather", "cannon"):
        what = f"matpow_sharded(n={SHARDED_N}, {name}, {alg}, p={POWER})"
        fn = (lambda alg=alg: matpow_sharded(a, POWER, mesh,
                                             algorithm=alg).full_tensor())
        got, delta, peak = launch_delta(fn)
        if delta != {k1: MULTS}:
            raise AssertionError(f"{what}: launches {delta}, expected "
                                 f"{{{k1!r}: {MULTS}}}")
        err = check_close(got, want, dtype, n=SHARDED_N, mults=MULTS,
                          what=what + " vs float64")
        rows.append({"n": SHARDED_N, "dtype": name, "algorithm": alg,
                     "launches": delta, "peak_mb": peak / 2 ** 20,
                     "max_abs_err_vs_f64": err[0],
                     "rel_to_peak_vs_f64": err[1], "rtol": err[2],
                     "sharded_ms": wall_ms(fn), "cuda_chain_ms": chain_ms})
    return rows


def sharded_engine(mesh) -> dict:
    """``MatFnEngine(mesh=...)``, default thresholds (64, 4096): one 4096
    f32 matpow and one markov steady state flushed together, both on the
    ``sharded`` route; K1 launches only (7 for A^96, one a squaring for the
    steady state); A^96 within budget of float64, the steady state's pi and
    squarings those of ``steady_state`` on the single-device chain."""
    a = power_operand(SHARDED_N, torch.float32, 910)
    p = stochastic(SHARDED_N, torch.float32, 911)
    eng = MatFnEngine(mesh=mesh)

    def flush():
        eng.submit("matpow", a, power=POWER)
        eng.submit("markov", p)
        return eng.flush()

    (got, res), delta, peak = launch_delta(flush)
    k = int(res.squarings)
    routes = eng.stats()["routes"]
    if routes["sharded"] != 2 or sum(routes.values()) != 2:
        raise AssertionError(f"sharded engine: routes {routes}")
    if delta != {"matmul": MULTS + k}:
        raise AssertionError(f"sharded engine: launches {delta}, expected "
                             f"{{'matmul': {MULTS + k}}}")
    what = f"engine sharded matpow(n={SHARDED_N}, float32, p={POWER})"
    err = check_close(got, f64_power(a, POWER, what=what), torch.float32,
                      n=SHARDED_N, mults=MULTS, what=what + " vs float64")
    want = steady_state(p, tol=MARKOV_TOL, backend="cuda_chain",
                        validate=False)
    if int(want.squarings) != k:
        raise AssertionError(f"sharded engine steady state: {k} squarings, "
                             f"the chain {int(want.squarings)}")
    pi_err = check_close(res.pi, want.pi, torch.float32, n=SHARDED_N,
                         mults=k, what="engine sharded steady state pi")
    return {"routes": routes, "launches": delta, "squarings": k,
            "residual": float(res.residual), "peak_mb": peak / 2 ** 20,
            "matpow_max_abs_err_vs_f64": err[0],
            "pi_max_abs_err_vs_chain": pi_err[0],
            "flush_ms": wall_ms(flush)}


def phase_sharded() -> None:
    """The sharded chain on a world-1 NCCL group and its 1x1 mesh (one card
    gives no other): A^96 at the main path's width, n = 4096, in f32, bf16
    and f64 with each schedule forced; ``expm_sharded`` at 4096 f32 against
    the port's ``expm``; an engine flush on the ``sharded`` route. A 1x1
    mesh sends nothing, so this shows that every local product is K1 and
    what the route costs on the host, not what collectives cost."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)       # before the mesh: NCCL's device
    rdzv = tempfile.mkdtemp(prefix="chip-smoke-rdzv-")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rows = [row for i, dtype in enumerate(SHARDED_DTYPES)
                for row in sharded_case(mesh, dtype, 900 + i)]
        e = randn((SHARDED_N, SHARDED_N), torch.float32, 905,
                  scale=SHARDED_EXPM_SCALE)
        got, delta, _ = launch_delta(
            lambda: expm_sharded(e, mesh).full_tensor())
        squarings = delta.get("matmul", 0)
        if set(delta) != {"matmul"}:
            raise AssertionError(f"expm_sharded: launches {delta}")
        err = check_close(got, expm(e), torch.float32, n=SHARDED_N,
                          mults=squarings + 7,
                          what=f"expm_sharded(n={SHARDED_N}) vs expm")
        expm_row = {"n": SHARDED_N, "dtype": "float32",
                    "squarings": squarings, "max_abs_err_vs_expm": err[0],
                    "rel_to_peak_vs_expm": err[1],
                    "expm_sharded_ms": wall_ms(
                        lambda: expm_sharded(e, mesh).full_tensor()),
                    "expm_ms": wall_ms(lambda: expm(e))}
        engine = sharded_engine(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    emit("sharded", mesh=[1, 1], power=POWER, rows=rows, expm=expm_row,
         engine=engine, seconds=round(time.perf_counter() - t0, 1))


# ---------------------------------------------------------------------------
# Phase lm: the LM serving path (every projection a K1 launch)
# ---------------------------------------------------------------------------

#: The published configs served at cut depth (the rest at full depth), so
#: that fp32 masters plus their bf16 copy fit the card's 80 GB.
LM_DEPTHS = {"mixtral-8x7b": 2, "llava-next-mistral-7b": 2,
             "starcoder2-15b": 2, "granite-34b": 2, "qwen1.5-110b": 1,
             "grok-1-314b": 1}
LM_OTHERS = ("zamba2-1.2b", "whisper-base", "mixtral-8x7b",
             "llava-next-mistral-7b", "starcoder2-15b", "granite-34b",
             "qwen1.5-110b", "grok-1-314b")


def lm_cut(cfg):
    """``cfg`` at the depth phase lm serves it (``LM_DEPTHS``)."""
    depth = LM_DEPTHS.get(cfg.name)
    return cfg if depth is None else cfg.replace(n_layers=depth)


def lm_k1_per_call(cfg, prefill: bool) -> int:
    """K1 launches one prefill (or one decode step) of ``cfg`` makes: one
    per projection, per MoE router and per expert product; the encoder and
    the cross K/V projections in the prefill only."""
    if cfg.n_experts:
        ffn = 1 + 3 * cfg.n_experts
    else:
        ffn = {"swiglu": 3, "plain": 2}[cfg.mlp_type] if cfg.d_ff else 0
    attn = 4 + ffn
    if cfg.layer_pattern:
        n_m_per = sum(k == "m" for k in cfg.layer_pattern)
        return (cfg.n_pattern_repeats * (2 * n_m_per + attn)
                + 2 * cfg.n_tail_layers)
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    per_layer = attn + ((4 if prefill else 2) if cfg.cross_attention else 0)
    enc = cfg.encoder_layers * attn if prefill else 0
    return cfg.n_layers * per_layer + enc


def lm_inputs(cfg, batch, prompt_len, seed):
    """Prompt tokens and the stub frontend inputs, on the card."""
    gen = torch.Generator("cuda").manual_seed(seed)
    cdt = repro_torch.DTYPES[cfg.compute_dtype]
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device="cuda")
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = (torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, device="cuda")
                        * 0.1).to(cdt)
    if cfg.family == "vlm":
        kw["vision_embeds"] = (torch.randn(
            (batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
            device="cuda") * 0.1).to(cdt)
    return toks, kw


def lm_only_k1(delta, want, what) -> None:
    """``delta`` (a launch-count change) is exactly ``want`` K1 launches of
    the bf16 kernel: no plain version, no other kernel."""
    if delta != {"matmul_tc": want}:
        raise AssertionError(f"{what}: launches {delta}, expected "
                             f"{{'matmul_tc': {want}}}")


def lm_serve(cfg, params, *, batch, prompt_len, new_tokens, seed):
    """The main path at one config: ``generate`` twice (first and second
    call), every K1 launch counted: exactly the config's count per prefill
    and per decode step, nothing else. Then the engine's ``prefill`` and
    decode function, each call timed alone (host clock ending in a
    synchronise; the decode steps back to back, one synchronise at the
    end), its launches read from the host counters and its logits held
    finite."""
    cfg = serve_engine.serve_config(cfg)
    toks, kw = lm_inputs(cfg, batch, prompt_len, seed)
    prefix = kw["vision_embeds"].shape[1] if "vision_embeds" in kw else 0
    cache_len = prefix + prompt_len + new_tokens
    per_prefill = lm_k1_per_call(cfg, True)
    per_step = lm_k1_per_call(cfg, False)
    want = per_prefill + (new_tokens - 1) * per_step
    dec = serve_engine.make_decode_fn(cfg)
    calls = []
    for call in ("first", "second"):
        K.reset_launches()
        A.reset_launches()
        row = {"call": call}
        out, row["generate_ms"] = wall_ms_once(lambda: serve_engine.generate(
            cfg, params, toks, max_new_tokens=new_tokens, **kw))
        lm_only_k1(lm_moved(), want, f"{cfg.name} generate ({call} call)")
        if out.shape != (batch, new_tokens) or out.min() < 0 \
                or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: generated {tuple(out.shape)} "
                                 f"tokens in [{out.min()}, {out.max()}]")
        row["tokens_per_s"] = batch * new_tokens / row["generate_ms"] * 1e3

        K.reset_launches()
        (logits, cache), row["prefill_ms"] = wall_ms_once(
            lambda: serve_engine.prefill(cfg, params, toks,
                                         cache_len=cache_len, **kw))
        lm_only_k1(lm_moved(), per_prefill, f"{cfg.name} prefill")
        finite = torch.isfinite(logits).all()
        cast = model_lib._cast_params(cfg, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            tok = logits[:, -1].argmax(-1)[:, None]
            K.reset_launches()
            logits, cache = dec(cast, tok, cache)
            lm_only_k1(lm_moved(), per_step, f"{cfg.name} decode step")
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        row["ms_per_decode_step"] = (time.perf_counter() - t0) * 1e3 \
            / (new_tokens - 1)
        if not finite:
            raise AssertionError(f"{cfg.name}: non-finite logits")
        del cast
        calls.append(row)
    return {"batch": batch, "prompt": prompt_len, "prefix": prefix,
            "new_tokens": new_tokens, "k1_per_prefill": per_prefill,
            "k1_per_step": per_step, "k1_launches": 2 * want,
            "calls": calls}


def lm_moved() -> dict:
    """Every launch counter (K1–K3 and K5, kernels and plain versions) that
    is not 0."""
    moved = {k: v for k, v in K.launch_counts().items() if v}
    moved.update({k: v for k, v in A.launch_counts().items() if v})
    return moved


def wall_ms_once(fn):
    """(``fn()``, its host ms ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_memory_gb(cfg) -> float:
    """fp32 masters plus their bf16 copy, GB."""
    return cfg.n_params() * 6 / 1e9


def lm_model(cfg, seed):
    """Random weights for ``cfg`` on the card from a seeded generator."""
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    if lm_memory_gb(cfg) > 0.9 * total:
        raise AssertionError(f"{cfg.name} at depth {cfg.n_layers}: "
                             f"{lm_memory_gb(cfg):.1f} GB of weights on a "
                             f"{total:.1f} GB card")
    return models_lib.init_params(
        cfg, torch.Generator("cuda").manual_seed(seed))


def lm_free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def lm_card_vs_cpu(cfg, params, seed) -> dict:
    """The same 2-layer weights on the card (K1) and on the CPU (the plain
    versions): the prefill's last-token logits and 4 teacher-forced decode
    steps within ``DENSE_BUDGET["bfloat16"]``."""
    cfg = serve_engine.serve_config(cfg)
    toks, _ = lm_inputs(cfg, 2, 68, seed)

    def run(p, t):
        logits, cache = serve_engine.prefill(cfg, p, t[:, :64],
                                             cache_len=68)
        outs = [logits[:, 0]]
        dec = serve_engine.make_decode_fn(cfg)
        for i in range(64, 68):
            logits, cache = dec(p, t[:, i:i + 1], cache)
            outs.append(logits[:, 0])
        return torch.stack(outs, 1).float().cpu()

    card = run(params, toks)
    host = run(model_lib._map(lambda x: x.cpu(), params), toks.cpu())
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    err = (card.double() - host.double()).abs()
    ok = torch.allclose(card.double(), host.double(), rtol=rtol, atol=atol)
    if not ok or not torch.isfinite(card).all():
        raise AssertionError(f"{cfg.name} card vs CPU: max abs err "
                             f"{err.max().item():.3e} outside rtol={rtol} "
                             f"atol={atol}")
    return {"layers": cfg.n_layers, "batch": 2, "prompt": 64,
            "decode_steps": 4, "max_abs_err": err.max().item(),
            "peak": host.abs().max().item(), "rtol": rtol, "atol": atol}


def lm_ring_check(seed) -> dict:
    """Mixtral-8x7B at depth 2 with a prompt of window + 4 tokens: four
    teacher-forced decode steps from the prefill's ring cache against the
    model's own forward, within ``DENSE_BUDGET["bfloat16"]``; beside it the
    same steps from the reference's cache layout (no roll)."""
    cfg = serve_engine.serve_config(lm_cut(configs.get_config(
        "mixtral-8x7b")))
    w = cfg.sliding_window
    s0 = w + 4
    params = lm_model(cfg, seed)
    toks, _ = lm_inputs(cfg, 1, s0 + 4, seed + 1)
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    with torch.inference_mode():
        cast = model_lib._cast_params(cfg, params)
        full = models_lib.unembed(cfg, cast, models_lib.forward(
            cfg, cast, toks)["x"][:, s0:])
        _, cache = serve_engine.prefill(cfg, params, toks[:, :s0],
                                        cache_len=s0 + 4)
        old = dict(cache)
        for key in ("k", "v"):
            old[key] = torch.roll(cache[key], -(s0 % w), dims=2)
        errs = {}
        for name, c in (("ring", cache), ("reference_layout", old)):
            worst = 0.0
            for i in range(4):
                logits, c = models_lib.decode_step(
                    cfg, cast, toks[:, s0 + i:s0 + i + 1], c)
                worst = max(worst, (logits[:, 0].double()
                                    - full[:, i].double()).abs().max().item())
            errs[name] = worst
    peak = full.abs().max().item()
    if not errs["ring"] <= atol + rtol * peak:
        raise AssertionError(f"mixtral ring cache: decode vs forward "
                             f"{errs['ring']:.3e} outside the bf16 budget")
    del params, cast
    lm_free()
    return {"layers": cfg.n_layers, "window": w, "prompt": s0,
            "decode_steps": 4, "max_abs_err": errs["ring"],
            "reference_layout_max_abs_err": errs["reference_layout"],
            "peak": peak}


#: K1 at the LM's shapes, bf16 (name, M, K, N): Qwen3-1.7B's projections
#: at decode (M = batch 4) and prefill (M = 4 x 512), Mamba2-130m's ``w_in``
#: (N = 3352, not a tile multiple).
LM_DENSE = (("qwen3 wq decode", 4, 2048, 2048),
            ("qwen3 w_gate decode", 4, 2048, 6144),
            ("qwen3 w_down decode", 4, 6144, 2048),
            ("mamba2 w_in decode", 4, 768, 3352),
            ("qwen3 w_gate prefill", 2048, 2048, 6144),
            ("mamba2 w_in prefill", 2048, 768, 3352))


def lm_dense_rows() -> list:
    """``ops.dense_matmul`` at the LM's shapes: K1 on operands padded once
    (``kernel_case``: held to its plain version, timed beside it and
    ``torch.matmul``), then the whole call, whose per-call padding of the
    activation (M up to K1's tile) and of a weight whose N or K is not a
    tile multiple is the difference; bound for the unpadded problem."""
    rows = []
    for i, (name, m, k, n) in enumerate(LM_DENSE):
        x = randn((m, k), torch.bfloat16, 2440 + i)
        w = randn((k, n), torch.bfloat16, 2450 + i)
        bm, bn, bk = ops.pick_blocks(m, n, k, dtype=torch.bfloat16,
                                     backend="cuda")
        row = kernel_case("matmul", torch.bfloat16,
                          (ops.pad_to_blocks(x, bm, bk),
                           ops.pad_to_blocks(w, bk, bn)),
                          (bm, bn, bk), timed=True, rows=[])
        b_ms, b_by = bound(2.0 * m * n * k, 2.0 * (m * k + k * n + m * n),
                           torch.bfloat16)
        got = ops.dense_matmul(x, w)
        check_kernel(got, K.matmul_plain(
            ops.pad_to_blocks(x, bm, bk), ops.pad_to_blocks(w, bk, bn),
            block_m=bm, block_n=bn, block_k=bk)[:m, :n], torch.bfloat16,
            what=f"dense_matmul {name}")
        rows.append({"case": name, "m": m, "k": k, "n": n,
                     "blocks": [bm, bn, bk],
                     "padded": [-(-m // bm) * bm, -(-k // bk) * bk,
                                -(-n // bn) * bn],
                     "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                     "library_ms": row["library_ms"],
                     "dense_matmul_ms": time_ms(lambda: ops.dense_matmul(x,
                                                                         w)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": row["max_abs_err"]})
    return rows


def phase_lm() -> dict:
    """The LM serving path: Qwen3-1.7B at full width and depth (batch 4,
    a 512-token prompt, 32 new tokens, greedy), its 2-layer cut on the card
    against the CPU, Mamba2-130m at full width and depth, the other eight
    configs at their published widths (2 x 128 prompt, 4 new tokens; the
    depths of ``LM_DEPTHS``), and the ring-cache check; first K1 at the
    LM's shapes (``lm_dense_rows``). Every projection is a K1 launch; the
    counts of the served runs are returned."""
    t0 = time.perf_counter()
    emit("lm_dense", rows=lm_dense_rows())
    totals = collections.Counter()
    rows = []
    qwen = configs.get_config("qwen3-1.7b")
    params = lm_model(qwen, 2400)
    served = lm_serve(qwen, params, batch=4, prompt_len=512, new_tokens=32,
                      seed=2401)
    totals["matmul_tc"] += served["k1_launches"]
    rows.append({"arch": qwen.name, "layers": qwen.n_layers,
                 "params": qwen.n_params(), **served})
    del params
    lm_free()
    emit("lm", **rows[-1])

    cut = qwen.replace(n_layers=2)
    params = lm_model(cut, 2402)
    vs_cpu = lm_card_vs_cpu(cut, params, 2403)
    del params
    lm_free()
    emit("lm", arch=qwen.name, card_vs_cpu=vs_cpu)

    mamba = configs.get_config("mamba2-130m")
    params = lm_model(mamba, 2404)
    served = lm_serve(mamba, params, batch=4, prompt_len=512,
                      new_tokens=32, seed=2405)
    totals["matmul_tc"] += served["k1_launches"]
    rows.append({"arch": mamba.name, "layers": mamba.n_layers,
                 "params": mamba.n_params(), **served})
    del params
    lm_free()
    emit("lm", **rows[-1])

    for i, name in enumerate(LM_OTHERS):
        cfg = lm_cut(configs.get_config(name))
        params = lm_model(cfg, 2410 + i)
        served = lm_serve(cfg, params, batch=2, prompt_len=128,
                          new_tokens=4, seed=2420 + i)
        totals["matmul_tc"] += served["k1_launches"]
        rows.append({"arch": name, "layers": cfg.n_layers,
                     "published_layers": configs.get_config(name).n_layers,
                     "params": cfg.n_params(),
                     "weights_gb": lm_memory_gb(cfg),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     **served})
        del params
        lm_free()
        torch.cuda.reset_peak_memory_stats()
        emit("lm", **rows[-1])

    ring = lm_ring_check(2430)
    emit("lm", arch="mixtral-8x7b", ring_cache=ring,
         seconds=round(time.perf_counter() - t0, 1))
    return dict(totals)


# ---------------------------------------------------------------------------
# Phase train: the LM training path (K1 forward, recomputed, dx and dw)
# ---------------------------------------------------------------------------

#: Qwen3-1.7B's and Mamba2-130m's steps: 8 sequences of 512 tokens in 4
#: microbatches of 2 (the configs' ``grad_accum``), 3 steps each.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 512, 4, 3
#: The 2-layer cut's batch (sequences, tokens) for the card-vs-CPU step and
#: the resume check; one microbatch.
TRAIN_CUT = (2, 128)
#: A gradient of the 2-layer cut on the card against the CPU: the norm of
#: the difference over the norm of the CPU's gradient. Both run the same
#: bf16 model; K1 and its plain version sum in different orders, so a bf16
#: rounding (2^-8 of a value) flips here and there and the flips carry
#: through two layers' backward; a small weight whose gradient sums many
#: cancelling terms (``k_norm``, 128 values over every token and head) shows
#: it most: 1.39e-2 on the card. 3e-2 is under eight bf16 units of the
#: norm, far below what a wrong product (an error of order 1) gives.
GRAD_REL_TOL = 3e-2
#: K1 at the backward shapes of Qwen3-1.7B's ``w_gate`` at microbatch
#: 2 x 512 (M = 1024), bf16: (name, M, K, N, the operand ``ops.matmul``
#: transposes into a copy: None, "b" (dx: g @ w.T) or "a" (dw: x.T @ g),
#: launches a step: 28 layers x 4 microbatches, x 2 for the forward and
#: its remat recomputation).
TRAIN_DENSE = (("qwen3 w_gate forward", 1024, 2048, 6144, None, 224),
               ("qwen3 w_gate dx", 1024, 6144, 2048, "b", 112),
               ("qwen3 w_gate dw", 2048, 1024, 6144, "a", 112))


def train_k1_per_microbatch(cfg) -> int:
    """K1 launches of one microbatch under remat ``"nothing"``: each
    projection's forward, its recomputation in the backward, ``dx`` and
    ``dw``."""
    return 4 * lm_k1_per_call(cfg, True)


def train_dense_rows() -> list:
    """K1 at the backward shapes (``TRAIN_DENSE``): the kernel on its
    operands as ``ops.matmul`` hands them over (``kernel_case``: held to the
    plain version, timed beside it and ``torch.matmul``), the transposing
    copy ``ops.matmul`` makes of a transposed operand, and the whole
    ``ops.matmul`` call on the transposed view."""
    rows = []
    for i, (name, m, k, n, transposed, per_step) in enumerate(TRAIN_DENSE):
        a = randn((m, k), torch.bfloat16, 2500 + i)
        b = randn((k, n), torch.bfloat16, 2510 + i)
        blocks = ops.pick_blocks(m, n, k, dtype=torch.bfloat16,
                                 backend="cuda")
        row = kernel_case("matmul", torch.bfloat16, (a, b), blocks,
                          timed=True, rows=[])
        # the views the backward passes: w.T of a (n', k') weight, x2.T
        view_a = a.T.contiguous().T if transposed == "a" else a
        view_b = b.T.contiguous().T if transposed == "b" else b
        copy_ms = 0.0
        if transposed is not None:
            src = view_a if transposed == "a" else view_b
            copy_ms = time_ms(lambda: src.contiguous())
        got = ops.matmul(view_a, view_b, blocks=blocks)
        check_kernel(got, K.matmul_plain(a, b, block_m=blocks[0],
                                         block_n=blocks[1],
                                         block_k=blocks[2]),
                     torch.bfloat16, what=f"ops.matmul {name}")
        rows.append({"case": name, "m": m, "k": k, "n": n,
                     "blocks": list(blocks), "transposed": transposed,
                     "kernel_ms": row["ms"], "copy_ms": copy_ms,
                     "ops_matmul_ms": time_ms(lambda: ops.matmul(
                         view_a, view_b, blocks=blocks)),
                     "plain_ms": row["plain_ms"],
                     "library_ms": row["library_ms"],
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                     "max_abs_err": row["max_abs_err"],
                     "launches_per_step": per_step})
    return rows


def train_run(cfg, seed) -> dict:
    """``TRAIN_STEPS`` steps of ``launch.train.build``'s step on
    ``SyntheticStream`` batches at full width and depth: per step host ms
    (ending in a synchronise), tokens/s, loss, ce, grad norm, lr, the exact
    K1 count (nothing else launched) and peak GB allocated."""
    params = lm_model(cfg, seed)
    state = init_train_state(cfg, params)
    del params
    step_fn, _ = train_launch.build(cfg, steps_total=1000, peak_lr=3e-4,
                                    accum=TRAIN_ACCUM)
    stream = SyntheticStream(cfg, seed=seed + 1, batch=TRAIN_BATCH,
                             seq=TRAIN_SEQ)
    want = TRAIN_ACCUM * train_k1_per_microbatch(cfg)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        batch = next(stream)
        K.reset_launches()
        A.reset_launches()
        (state, metrics), ms = wall_ms_once(lambda: step_fn(state, batch))
        lm_only_k1(lm_moved(), want, f"{cfg.name} train step {i}")
        m = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{cfg.name} train step {i}: {m}")
        steps.append({"step": i, "ms": ms,
                      "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
                      "loss": m["loss"], "ce": m["ce"], "aux": m["aux"],
                      "grad_norm": m["grad_norm"], "lr": m["lr"],
                      "k1_launches": want,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del state, batch
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "params": cfg.n_params(), "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM,
            "k1_per_microbatch": train_k1_per_microbatch(cfg),
            "k1_per_step": want, "steps": steps}


def _tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def train_card_vs_cpu(cut, params, seed) -> dict:
    """One step of the 2-layer cut at full width from the same weights and
    batch on the card (K1: 4 launches a projection) and on the CPU (the
    plain versions): loss and ce under ``DENSE_BUDGET["bfloat16"]``; every
    gradient (the clipped gradient the first step's moment holds: m =
    (1 - b1) g) and the grad norm within ``GRAD_REL_TOL`` of the CPU's,
    relative to the CPU's norm."""
    b, s = TRAIN_CUT
    batch = make_batch(cut, step=0, seed=seed, batch=b, seq=s)
    step = make_train_step(cut, accum=1, warmup=2, peak_lr=1e-3)
    card = init_train_state(cut, model_lib._map(torch.clone, params))
    K.reset_launches()
    A.reset_launches()
    _, m_card = step(card, batch)
    lm_only_k1(lm_moved(), train_k1_per_microbatch(cut),
               f"{cut.name} 2-layer train step")
    host = init_train_state(cut, model_lib._map(lambda x: x.cpu(), params))
    _, m_host = step(host, {k: v.cpu() for k, v in batch.items()})
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    out = {"layers": cut.n_layers, "batch": b, "seq": s, "rtol": rtol,
           "atol": atol, "grad_rel_tol": GRAD_REL_TOL}
    for k in ("loss", "ce"):
        got, want = float(m_card[k]), float(m_host[k])
        out[k] = [got, want]
        if not (math.isfinite(got) and abs(got - want) <= atol
                + rtol * abs(want)):
            raise AssertionError(f"2-layer train {k}: card {got} vs CPU "
                                 f"{want} outside the bf16 budget")
    gn = [float(m_card["grad_norm"]), float(m_host["grad_norm"])]
    out["grad_norm"] = gn
    worst = ("", 0.0)
    host_m = dict(_tree_leaves(host["opt"]["m"]))
    for name, g in _tree_leaves(card["opt"]["m"]):
        want = host_m[name].double()
        rel = ((g.cpu().double() - want).norm()
               / want.norm().clamp_min(1e-30)).item()
        if not rel <= GRAD_REL_TOL:
            raise AssertionError(f"2-layer train gradient {name}: "
                                 f"{rel:.3e} of its norm off the CPU's")
        worst = max(worst, (name, rel), key=lambda t: t[1])
    if not abs(gn[0] - gn[1]) <= GRAD_REL_TOL * gn[1]:
        raise AssertionError(f"2-layer train grad norm {gn}")
    out["worst_grad"] = {"name": worst[0], "rel_err": worst[1]}
    del card, host
    return out


def train_resume(cut, params, seed) -> dict:
    """The reference's ``test_checkpoint_resume_bitexact`` on the card: 4
    steps straight against 2 steps, an async save, a restore into a fresh
    state, 2 steps from the stream's saved position. The same kernels run
    on the same inputs, so every leaf is held to the bit; were one not, it
    would be reported and held to ``DENSE_BUDGET["bfloat16"]``. Exactly
    4 K1 launches a projection a step, 8 steps."""
    b, s = TRAIN_CUT
    step = make_train_step(cut, accum=1, warmup=2, peak_lr=1e-3)
    K.reset_launches()
    A.reset_launches()

    def run(state, stream, n):
        for _ in range(n):
            state, metrics = step(state, next(stream))
        return state

    straight = run(init_train_state(cut, model_lib._map(torch.clone,
                                                        params)),
                   SyntheticStream(cut, seed=seed, batch=b, seq=s), 4)
    half = run(init_train_state(cut, model_lib._map(torch.clone, params)),
               SyntheticStream(cut, seed=seed, batch=b, seq=s), 2)
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        ck = Checkpointer(root, keep=1)
        ck.save(2, half, blocking=False)
        del half
        ck.wait()
        fresh = init_train_state(cut, lm_model(cut, seed + 1))
        at, restored = ck.restore(None, fresh)
        del fresh
        resumed = run(restored, SyntheticStream(cut, seed=seed, batch=b,
                                                seq=s, start_step=at), 2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = 8 * train_k1_per_microbatch(cut)
    lm_only_k1(lm_moved(), launches, f"{cut.name} resume")
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    same, worst = True, 0.0
    got = dict(_tree_leaves(resumed))
    for name, want in _tree_leaves(straight):
        if not torch.equal(got[name], want):
            same = False
            err = (got[name].double() - want.double()).abs().max().item()
            worst = max(worst, err)
            if not torch.allclose(got[name].double(), want.double(),
                                  rtol=rtol, atol=atol):
                raise AssertionError(f"resume: {name} off by {err:.3e}")
    return {"steps": [4, 2, 2], "k1_launches": launches,
            "bitexact": same, "max_abs_err": worst}


def phase_train() -> dict:
    """The LM training path: K1 at the backward shapes, Qwen3-1.7B and
    Mamba2-130m trained at full width and depth (``train_run``), the
    2-layer cut on the card against the CPU and its checkpoint resume.
    Returns the K1 launches of the training runs."""
    t0 = time.perf_counter()
    emit("train_dense", rows=train_dense_rows())
    totals = collections.Counter()
    for name, seed in (("qwen3-1.7b", 2600), ("mamba2-130m", 2610)):
        row = train_run(configs.get_config(name), seed)
        totals["matmul_tc"] += row["k1_per_step"] * TRAIN_STEPS
        emit("train", **row)
    cut = configs.get_config("qwen3-1.7b").replace(n_layers=2)
    params = lm_model(cut, 2620)
    vs_cpu = train_card_vs_cpu(cut, params, 2621)
    totals["matmul_tc"] += train_k1_per_microbatch(cut)
    resume = train_resume(cut, params, 2622)
    totals["matmul_tc"] += resume["k1_launches"]
    del params
    lm_free()
    emit("train", arch=cut.name, card_vs_cpu=vs_cpu, resume=resume,
         seconds=round(time.perf_counter() - t0, 1))
    return dict(totals)


# ---------------------------------------------------------------------------
# Phase lm_mesh: the LM on a device mesh (DTensors; K1 on the local shards)
# ---------------------------------------------------------------------------

#: Decode on the mesh: batch, prompt tokens, greedy tokens (phase lm's).
MESH_DECODE = (4, 512, 32)
#: The compressed all-reduce's operand: 4M fp32 values (16 MB).
MESH_PSUM_SHAPE = (4096, 1024)


class CudaProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts ``aten.mm`` / ``bmm`` / ``addmm`` on CUDA tensors (on a mesh,
    the DTensor-level op: the mode sees it before DTensor runs it on the
    local shards)."""
    OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default)

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS and any(isinstance(a, torch.Tensor) and a.is_cuda
                                    for a in args):
            self.n += 1
        return func(*args, **(kwargs or {}))


def full(x):
    """A DTensor's full value (every rank's alike); a tensor as it is."""
    return x.full_tensor() if repro_torch.is_dtensor(x) else x


def host_params(state) -> dict:
    """The state's parameters, whole, in fp32 on the host ({path: tensor});
    the card's memory is left as it was."""
    return {k: full(v).detach().to("cpu", torch.float32, copy=True)
            for k, v in _tree_leaves(state["params"])}


def mesh_steps(cfg, step_fn, state, batch, want, *, mesh) -> tuple:
    """Two steps of ``step_fn`` on one batch: step 0 counted (K1 exactly
    ``want``, the CUDA products, on a mesh the collectives by kind), its
    metrics read and its change of every parameter taken (on the host, so
    peak GB counts the step alone); step 1 timed alone (host ms ending in a
    synchronise, K1 exactly ``want`` again). Peak GB over both. Returns
    (row, {path: the parameter's change in step 0})."""
    from torch.distributed.tensor.debug import CommDebugMode
    before = host_params(state)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    A.reset_launches()
    comm = CommDebugMode() if mesh is not None else None
    with CudaProducts() as products:
        if comm is not None:
            with comm:
                (state, metrics), ms0 = wall_ms_once(
                    lambda: step_fn(state, batch))
        else:
            (state, metrics), ms0 = wall_ms_once(
                lambda: step_fn(state, batch))
    lm_only_k1(lm_moved(), want, f"{cfg.name} step 0")
    m = {k: float(full(v)) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in m.values()):
        raise AssertionError(f"{cfg.name}: {m}")
    peak = torch.cuda.max_memory_allocated()
    change = {k: v - before.pop(k) for k, v in host_params(state).items()}
    norm = math.sqrt(sum(float(d.double().square().sum())
                         for d in change.values()))
    if not norm > 0:
        raise AssertionError(f"{cfg.name}: step 0 left every parameter "
                             f"as it was")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    A.reset_launches()
    _, ms = wall_ms_once(lambda: step_fn(state, batch))
    lm_only_k1(lm_moved(), want, f"{cfg.name} step 1")
    row = {"loss": m["loss"], "ce": m["ce"], "grad_norm": m["grad_norm"],
           "param_change_norm": norm,
           "k1_per_step": want, "cuda_products_per_step": products.n,
           "ms_counted_step": ms0, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
           "peak_gb": max(peak, torch.cuda.max_memory_allocated()) / 1e9}
    if comm is not None:
        row["collectives"] = {str(k): v
                              for k, v in comm.get_comm_counts().items()}
    return row, change


def lm_mesh_train(cfg, seed, mesh) -> dict:
    """Phase train's Qwen3-1.7B step (8 x 512 tokens in 4 microbatches,
    remat "nothing") without a mesh, then through
    ``launch.train.build(mesh=...)`` from the same seeded state and batch,
    the first state freed before the second is made. On the 1x1 mesh the
    two steps run the same kernels on the same shapes, so loss, ce, grad
    norm and every parameter's change in the step must be equal bit for
    bit (the relative gaps are reported beside ``DENSE_BUDGET
    ["bfloat16"]``, the budget of a mesh of several cards); K1 exactly the
    unsharded step's count, the CUDA products the unsharded step's
    count."""
    batch = next(SyntheticStream(cfg, seed=seed + 1, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ))
    want = TRAIN_ACCUM * train_k1_per_microbatch(cfg)
    step_fn, _ = train_launch.build(cfg, steps_total=1000, peak_lr=3e-4,
                                    accum=TRAIN_ACCUM)
    one, one_change = mesh_steps(
        cfg, step_fn, init_train_state(cfg, lm_model(cfg, seed)), batch,
        want, mesh=None)
    lm_free()
    step_fn, shardings = train_launch.build(cfg, mesh=mesh, steps_total=1000,
                                            peak_lr=3e-4, accum=TRAIN_ACCUM)
    state = sharding.place(init_train_state(cfg, lm_model(cfg, seed)),
                           shardings)
    placed = sharding.named(mesh, sharding.batch_specs(mesh, "lm"))
    on_mesh, change = mesh_steps(cfg, step_fn, state,
                                 {k: sharding.place(v, placed[k])
                                  for k, v in batch.items()}, want, mesh=mesh)
    del state
    lm_free()
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    gaps = {k: abs(on_mesh[k] - one[k]) / abs(one[k])
            for k in ("loss", "ce", "grad_norm", "param_change_norm")}
    unequal = [k for k in ("loss", "ce", "grad_norm") if on_mesh[k] != one[k]]
    unequal += [k for k, d in change.items()
                if not torch.equal(d, one_change[k])]
    change_diff = max(float((d - one_change[k]).abs().max())
                      for k, d in change.items())
    del change, one_change
    if unequal:
        raise AssertionError(f"lm_mesh train on 1x1: {len(unequal)} of the "
                             f"metrics and parameter changes differ from "
                             f"the unsharded step's, first {unequal[:3]}")
    if on_mesh["cuda_products_per_step"] != one["cuda_products_per_step"]:
        raise AssertionError(
            f"lm_mesh train: {on_mesh['cuda_products_per_step']} CUDA "
            f"products a step on the mesh, "
            f"{one['cuda_products_per_step']} on one device")
    return {"arch": cfg.name, "layers": cfg.n_layers, "mesh": [1, 1],
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "accum": TRAIN_ACCUM,
            "remat": cfg.remat_policy, "rtol": rtol, "atol": atol,
            "rel_gaps": gaps, "bitexact": True,
            "param_change_max_abs_diff": change_diff,
            "unsharded": one, "on_mesh": on_mesh}


def mesh_decode_run(cfg, params, toks, sctx, teacher=None) -> dict:
    """``prefill`` then ``MESH_DECODE[2] - 1`` decode steps of the engine
    on ``sctx``: greedy, or fed ``teacher``'s tokens (the unsharded run's)
    so that both runs see the same inputs. Every step exactly phase lm's
    K1 count; the steps timed back to back, one synchronise at the end."""
    b, prompt, new = MESH_DECODE
    per_step = lm_k1_per_call(cfg, False)
    where = "a mesh" if sctx.mesh is not None else "one device"
    cast = model_lib._cast_params(cfg, params)
    K.reset_launches()
    A.reset_launches()
    logits, cache = serve_engine.prefill(cfg, params, toks,
                                         cache_len=prompt + new, sctx=sctx)
    lm_only_k1(lm_moved(), lm_k1_per_call(cfg, True),
               f"{cfg.name} prefill on {where}")
    steps = [full(logits)[:, -1].float()]
    tokens = [steps[0].argmax(-1)]
    dec = serve_engine.make_decode_fn(cfg, sctx=sctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(new - 1):
        tok = (tokens[-1] if teacher is None else teacher[:, i])[:, None]
        K.reset_launches()
        A.reset_launches()
        logits, cache = dec(cast, tok, cache)
        lm_only_k1(lm_moved(), per_step,
                   f"{cfg.name} decode step on {where}")
        steps.append(full(logits)[:, -1].float())
        tokens.append(steps[-1].argmax(-1))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
    return {"logits": torch.stack(steps, 1), "tokens": torch.stack(tokens, 1),
            "ms_per_decode_step": ms, "k1_per_step": per_step}


def lm_mesh_decode(cfg, seed, mesh) -> dict:
    """Qwen3-1.7B served on the mesh (weights by ``param_specs(...,
    "decode")``, the cache by ``cache_partition_specs``) against the
    unsharded engine, the mesh's steps fed the unsharded tokens: every
    step's logits under ``DENSE_BUDGET["bfloat16"]``, and the greedy
    tokens, a token that differs allowed only where the unsharded top two
    logits are within twice the budget's atol (a near-tie, a fixed
    threshold). On the 1x1 mesh the two runs take the same kernels on the
    same shapes, so the logits must also be equal bit for bit."""
    from repro_torch.models.layers import ShardCtx
    cfg = serve_engine.serve_config(cfg)
    b, prompt, new = MESH_DECODE
    params = lm_model(cfg, seed)
    toks, _ = lm_inputs(cfg, b, prompt, seed + 1)
    one = mesh_decode_run(cfg, params, toks, ShardCtx())
    spec = sharding.param_specs(params, cfg, mesh, "decode")
    placed = sharding.place(params, sharding.named(mesh, spec))
    on_mesh = mesh_decode_run(cfg, placed, toks, ShardCtx(mesh=mesh),
                              teacher=one["tokens"])
    del params, placed
    lm_free()
    rtol, atol = fastmm.DENSE_BUDGET["bfloat16"]
    got, want = on_mesh["logits"].double(), one["logits"].double()
    err = (got - want).abs()
    off = ~torch.isclose(got, want, rtol=rtol, atol=atol)
    if bool(off.any()):
        steps = sorted({int(i) for i in off.nonzero()[:, 1]})
        raise AssertionError(f"lm_mesh decode: logits off by "
                             f"{err.max().item():.3e} at steps {steps[:8]}")
    top2 = one["logits"].topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * atol
    same = on_mesh["tokens"] == one["tokens"]
    if bool((~same & ~tie).any()):
        raise AssertionError(f"lm_mesh decode: {int((~same & ~tie).sum())} "
                             f"tokens differ without a near-tie")
    if not torch.equal(on_mesh["logits"], one["logits"]):
        raise AssertionError(f"lm_mesh decode on 1x1: logits differ from "
                             f"the unsharded engine's by "
                             f"{err.max().item():.3e}")
    return {"arch": cfg.name, "mesh": [1, 1], "batch": b, "prompt": prompt,
            "new_tokens": new, "rtol": rtol, "atol": atol,
            "logits_max_abs_err": err.max().item(),
            "logits_peak": want.abs().max().item(), "bitexact": True,
            "tokens_agree": int(same.sum()), "tokens": int(same.numel()),
            "near_ties": int(tie.sum()), "near_tie_gap": 2 * atol,
            "k1_per_step": on_mesh["k1_per_step"],
            "ms_per_decode_step": on_mesh["ms_per_decode_step"],
            "unsharded_ms_per_decode_step": one["ms_per_decode_step"]}


def lm_mesh_compressed(mesh, seed) -> dict:
    """``compressed_psum`` / ``ef_compress`` over the mesh's data dim on
    NCCL (a MAX all-reduce of fp32 scales, a SUM all-reduce of int32):
    with one rank the sum is the dequantized requantized input, exactly,
    and the residual the input less it."""
    import torch.distributed as dist
    x = randn(MESH_PSUM_SHAPE, torch.float32, seed)
    q, scale, meta = quantize_int8(x)
    want = dequantize_int8(q, scale, meta)
    got = compressed_psum(x, (mesh, "data"))
    red, err = ef_compress(x, torch.zeros_like(x), (mesh, "data"))
    exact = {"compressed_psum": torch.equal(got, want),
             "ef_compress_sum": torch.equal(red, want),
             "ef_compress_residual": torch.equal(err, x - want)}
    if not all(exact.values()):
        raise AssertionError(f"compressed_psum on one rank: {exact}")
    group = mesh.get_group("data")

    def fp32_all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y
    return {"shape": list(MESH_PSUM_SHAPE), "block": 256, "exact": exact,
            "max_abs_err_vs_input": (got - x).abs().max().item(),
            "compressed_psum_ms": wall_ms(
                lambda: compressed_psum(x, (mesh, "data"))),
            "fp32_all_reduce_ms": wall_ms(fp32_all_reduce)}


def phase_lm_mesh() -> dict:
    """The LM on a 1x1 NCCL ``("data", "model")`` mesh, the one card's: a
    Qwen3-1.7B train step and decode on DTensors (line ``lm_mesh_train``,
    ``lm_mesh_decode``) and the compressed all-reduce (line
    ``compressed_psum``). A 1x1 mesh sends nothing a collective could be
    timed by; this shows that every projection is K1 on the local shards
    and what DTensor costs on the host. Returns the K1 launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    rdzv = tempfile.mkdtemp(prefix="chip-smoke-rdzv-")
    dist.init_process_group("nccl", init_method=f"file://{rdzv}/rdzv",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        qwen = configs.get_config("qwen3-1.7b")
        train = lm_mesh_train(qwen, 2700, mesh)
        emit("lm_mesh_train", **train)
        decode = lm_mesh_decode(qwen, 2710, mesh)
        emit("lm_mesh_decode", **decode)
        emit("compressed_psum", **lm_mesh_compressed(mesh, 2720))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    emit("lm_mesh", seconds=round(time.perf_counter() - t0, 1))
    b, prompt, new = MESH_DECODE
    steps = 4 * train["on_mesh"]["k1_per_step"]     # 2 steps each, 2 runs
    per_call = lm_k1_per_call(qwen, True) + (new - 1) * decode["k1_per_step"]
    return {"matmul_tc": steps + 2 * per_call}


# ---------------------------------------------------------------------------
# Phase dryrun: the dry run's counts of phase train's step against the card
# ---------------------------------------------------------------------------

#: Phase train's Qwen3-1.7B step as a dry-run cell on a fake one-rank group
#: (meta tensors, no device), in a child process: full width, 28 layers by
#: extrapolation (``launch.dryrun.TRACED``), 8 x 512 tokens in 4
#: microbatches (``choose_accum(8, 1, grad_accum=4)``), remat "nothing".
DRYRUN_CHILD = """
import json, time
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
t0 = time.perf_counter()
with dryrun.fake_group(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cost, cfg, _ = dryrun.count_cell(
        "qwen3-1.7b", ShapeSpec("train_8x512", {seq}, {batch}, "train"), mesh)
print(json.dumps({{**cost.to_dict(), "accum": cfg.grad_accum,
                  "remat": cfg.remat_policy,
                  "count_s": time.perf_counter() - t0}}))
"""
#: The dry run's peak live bytes against the card's
#: ``max_memory_allocated`` for the same step: within a factor of 2 either
#: way (the caching allocator's rounding, K1's padded operands and the
#: library workspaces are not in the dry run).
DRYRUN_PEAK_FACTOR = 2.0
#: Steps timed after the counted one, without the counters.
DRYRUN_TIMED = 2


def dryrun_count() -> dict:
    """The child's counts (``DRYRUN_CHILD``); raises if it fails."""
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src")}
    code = DRYRUN_CHILD.format(seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"dry-run child failed:\n{done.stderr[-3000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def phase_dryrun() -> dict:
    """The dry run (``launch.dryrun`` on meta tensors) against the card on
    phase train's Qwen3-1.7B step: the child's FLOPs, bytes, ``dense_mm``
    calls and peak live GB; then the same step on the card under
    ``FlopCounterMode`` and the op counter (``analysis.op_cost``), with
    ``max_memory_allocated``; the dry run's three roofline terms
    (``analysis.roofline``, H100 data-sheet constants) and the ms of
    ``DRYRUN_TIMED`` steps timed without counters. Fails unless the FLOP
    counts are equal, the dry run counts the K1 launches of the step (one
    ``dense_mm`` each, exactly ``TRAIN_ACCUM`` x phase train's per
    microbatch) and the peaks agree within ``DRYRUN_PEAK_FACTOR``. Returns
    the K1 launches."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import op_cost, roofline

    t0 = time.perf_counter()
    dry = dryrun_count()
    cfg = configs.get_config("qwen3-1.7b")
    want = TRAIN_ACCUM * train_k1_per_microbatch(cfg)
    if dry["dense_mm_calls"] != want or dry["accum"] != TRAIN_ACCUM:
        raise AssertionError(f"dry run: {dry['dense_mm_calls']} dense_mm "
                             f"calls in {dry['accum']} microbatches, phase "
                             f"train launches K1 {want} times in "
                             f"{TRAIN_ACCUM}")
    state = init_train_state(cfg, lm_model(cfg, 2800))
    step_fn, _ = train_launch.build(cfg, steps_total=1000, peak_lr=3e-4,
                                    accum=TRAIN_ACCUM)
    batch = next(SyntheticStream(cfg, seed=2801, batch=TRAIN_BATCH,
                                 seq=TRAIN_SEQ))
    lm_free()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    A.reset_launches()
    with op_cost.OpCounter() as counter, \
            FlopCounterMode(display=False) as flops:
        counter.track((state, batch))
        _, counted_ms = wall_ms_once(lambda: step_fn(state, batch))
    lm_only_k1(lm_moved(), want, "dryrun counted step")
    card = {"flops": flops.get_total_flops(),
            "op_counter_flops": counter.flops,
            "dense_mm_calls": counter.dense_mm_calls, "k1_launches": want,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "op_counter_peak_gb": counter.peak / 1e9,
            "counted_step_ms": counted_ms}
    del counter
    timed = []
    for _ in range(DRYRUN_TIMED):
        _, ms = wall_ms_once(lambda: step_fn(state, batch))
        timed.append(ms)
    lm_only_k1(lm_moved(), want * (1 + DRYRUN_TIMED), "dryrun timed steps")
    del state, batch
    lm_free()
    cost = op_cost.OpCost(
        flops=dry["flops"], bytes=dry["bytes"],
        collectives=dry["collectives"], peak_bytes=dry["peak_bytes"],
        dense_mm_calls=dry["dense_mm_calls"], depth=dry["depth"],
        depths=tuple(dry["depths"]))
    shape = configs.ShapeSpec("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    rep = roofline.analyze(arch=cfg.name, shape_name=shape.name,
                           mesh_name="1x1", n_devices=1, cost=cost,
                           cfg=cfg, shape=shape)
    measured = min(timed)
    peak_ratio = dry["peak_bytes"] / 1e9 / card["max_memory_allocated_gb"]
    row = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "accum": dry["accum"], "remat": dry["remat"],
           "traced_depths": dry["depths"],
           "dry": {"flops": dry["flops"], "bytes": dry["bytes"],
                   "peak_gb": dry["peak_bytes"] / 1e9,
                   "dense_mm_calls": dry["dense_mm_calls"],
                   "count_s": dry["count_s"]},
           "card": card,
           "roofline_ms": {"compute": rep.compute_s * 1e3,
                           "memory": rep.memory_s * 1e3,
                           "collective": rep.collective_s * 1e3,
                           "dominant": rep.dominant},
           "useful_ratio": rep.useful_ratio,
           "measured_ms": timed,
           "compute_over_measured": rep.compute_s * 1e3 / measured,
           "memory_over_measured": rep.memory_s * 1e3 / measured,
           "peak_ratio": peak_ratio,
           "seconds": round(time.perf_counter() - t0, 1)}
    emit("dryrun", **row)
    if not dry["flops"] == card["flops"] == card["op_counter_flops"]:
        raise AssertionError(f"dry run {dry['flops']} FLOPs, the card's "
                             f"FlopCounterMode {card['flops']}, op counter "
                             f"{card['op_counter_flops']}")
    if card["dense_mm_calls"] != want:
        raise AssertionError(f"the card's step made {card['dense_mm_calls']}"
                             f" dense_mm calls, {want} K1 launches")
    if not 1 / DRYRUN_PEAK_FACTOR <= peak_ratio <= DRYRUN_PEAK_FACTOR:
        raise AssertionError(f"dry-run peak {row['dry']['peak_gb']:.2f} GB "
                             f"against the card's "
                             f"{card['max_memory_allocated_gb']:.2f} GB")
    return {"matmul_tc": want * (1 + DRYRUN_TIMED)}


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
        t_new = time.perf_counter()
        phase_strassen()
        phase_markov()
        emit("strassen_markov_phases",
             seconds=round(time.perf_counter() - t_new, 1))
        t_serve = time.perf_counter()
        pool, capacity = phase_serve()
        phase_serve_daemon(pool, capacity)
        phase_matserve()
        phase_dispatch()
        phase_sharded()
        emit("serving_phases", seconds=round(time.perf_counter() - t_serve,
                                             1))
        attn_counts, attn_timed = phase_attention()
        phase_tuning()
        lm_counts = phase_lm()
        train_counts = phase_train()
        mesh_counts = phase_lm_mesh()
        dryrun_counts = phase_dryrun()
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    counts = {**counts, **attn_counts}
    for name, n in (*lm_counts.items(), *train_counts.items(),
                    *mesh_counts.items(), *dryrun_counts.items()):
        counts[name] += n
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
