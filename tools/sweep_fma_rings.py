#!/usr/bin/env python3
"""Sweep the rings of the FMA kernels (csrc/gemm.cuh) on one GPU.

    python3 tools/sweep_fma_rings.py [--out DIR] [--variants NAME,...]

K1 and K3 in f32 take their K step and stage count at compile
time (the ``REPRO_F32_TILE`` lines; ``kPanelBK`` / ``kPanelStages``), so
each point of the sweep is a build of its own; so is K1's kernel at tile
128: the wide kernel as built (``matmul_wide_kernel``) or, as the baseline,
``matmul_kernel`` on 8 x 8 thread tiles in 256 threads, the design it
replaced. For every variant in ``VARIANTS`` this script copies
``src/repro_torch`` into ``DIR/<variant>``, rewrites those lines and
constants in ``gemm.cuh`` and the matching constants of
``kernels/matmul.py``, and in a child process on that copy: builds the
kernels (first use), prints ``nvcc -Xptxas -v``'s registers and spills for
the FMA K1 and K3, checks K1 and K3 against their plain versions (and K1 at
tile 128 against tile 64 bit for bit) and times them (device time,
``autotune.device_times_us``: CUDA-event medians over replays of a CUDA
graph of back-to-back calls) at the main path's shapes, beside the bound
at 67 TFLOP/s and ``torch.matmul``. One JSON line per variant on stdout,
then one line with the card's name and power limit. Needs a CUDA device
and ``nvcc``; imports ``repro_torch`` (the copy's) only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

#: name -> (stages of K1's tile-128 pairs by K step, where not the built
#: ones; K3's K step; K3's stages; K1's kernel at tile 128: "wide" or
#: "8x8", the baseline, at the rings it had)
VARIANTS = {
    "t128_8x8": ({16: 4, 32: 3}, 32, 3, "8x8"),
    "t128_wide": ({}, 32, 3, "wide"),
    "t128_wide_s2": ({16: 2, 32: 2}, 32, 3, "wide"),
    "t128_wide_s3": ({16: 3, 32: 3}, 32, 3, "wide"),
    "k3bk32s2": ({}, 32, 2, "wide"),
    "k3bk16s4": ({}, 16, 4, "wide"),
}

#: K1 f32 cases: (A's shape, B's shape, blocks): the tile-128 shapes of the
#: main path (the 2048^2 Strassen leaves of an 8192 operand, the 4096^2
#: local products of a 2 x 2 mesh, 1536^2 and 3072^2, a stack against a
#: broadcast B) and two tile-64 controls. K3 cases: (shape, dtype name,
#: blocks, grids (panel height, column width, groups) timed beside the one
#: ``square_panel_grid`` picks).
K1_CASES = [((4096, 4096), (4096, 4096), (128, 128, 32)),
            ((4096, 4096), (4096, 4096), (128, 128, 16)),
            ((3072, 3072), (3072, 3072), (128, 128, 32)),
            ((2048, 2048), (2048, 2048), (128, 128, 32)),
            ((2048, 2048), (2048, 2048), (128, 128, 16)),
            ((1536, 1536), (1536, 1536), (128, 128, 32)),
            ((2, 1536, 1536), (1536, 1536), (128, 128, 32)),
            ((4096, 4096), (4096, 4096), (64, 64, 32)),
            ((1024, 1024), (1024, 1024), (64, 64, 32))]
#: Operations a second of the H100's fp32 FMA pipeline (the bound's rate).
FMA_FLOPS = 67e12
K3_CASES = [((512, 512), "float32", (64, 64, 32),
             [(32, 32, 16), (64, 64, 8), (32, 64, 4)]),
            ((64, 256, 256), "float32", (64, 64, 32),
             [(64, 64, 2), (64, 64, 4), (32, 64, 1), (32, 64, 2),
              (32, 64, 4), (32, 32, 4)]),
            ((704, 704), "float32", (64, 64, 32), [(32, 64, 11)])]


def rewrite(pkg: Path, k1_stages: dict, panel_bk: int, panel_stages: int,
            tile128: str):
    """Set the variant's rings and K1's tile-128 kernel in a copy of the
    package."""
    cuh = pkg / "kernels" / "csrc" / "gemm.cuh"
    py = pkg / "kernels" / "matmul.py"
    src = cuh.read_text()
    pysrc = py.read_text()
    if tile128 == "8x8":
        # no tile is the wide kernel's; matmul_kernel takes 128 as before
        src = re.sub(r"^constexpr int kWideTile = \d+;",
                     "constexpr int kWideTile = 0;", src, flags=re.M)
        src = src.replace(
            "template <int TILE> struct MatmulLayout;\n",
            "template <int TILE> struct MatmulLayout;\n"
            "template <> struct MatmulLayout<128> "
            "{ using L = FmaLayout<8, 8, 4, 2>; };\n")
        pysrc = re.sub(r"^WIDE_TILE = \d+", "WIDE_TILE = 0", pysrc,
                       flags=re.M)
    for bk, stages in k1_stages.items():
        src = re.sub(rf"^(\s*REPRO_F32_TILE\(128, {bk}, )\d+\)",
                     rf"\g<1>{stages})", src, flags=re.M)
        pysrc = re.sub(rf"\(128, {bk}\): \d+", f"(128, {bk}): {stages}",
                       pysrc)
    src = re.sub(r"^constexpr int kPanelBK = \d+;",
                 f"constexpr int kPanelBK = {panel_bk};", src, flags=re.M)
    src = re.sub(r"^constexpr int kPanelStages = \d+;",
                 f"constexpr int kPanelStages = {panel_stages};", src,
                 flags=re.M)
    cuh.write_text(src)
    pysrc = re.sub(r"^FMA_PANEL_BK = \d+", f"FMA_PANEL_BK = {panel_bk}",
                   pysrc, flags=re.M)
    pysrc = re.sub(r"^FMA_PANEL_STAGES = \d+",
                   f"FMA_PANEL_STAGES = {panel_stages}", pysrc, flags=re.M)
    py.write_text(pysrc)


def ptxas(csrc: Path) -> dict:
    """Registers and spill bytes of the FMA K1 / K3 per instantiation."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = {}
    for unit in ("matmul_f32",):
        done = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-I", str(csrc), "-c",
             str(csrc / f"{unit}.cu"), "-o", os.devnull],
            capture_output=True, text=True, check=True)
        name = None
        for line in done.stderr.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                kernel = re.search(
                    r"(matmul_wide_kernel|matmul_kernel|square_panel_kernel)"
                    r"I(\w)", entry.group(1))
                name = None if kernel is None else (
                    f"{kernel.group(1)}<{kernel.group(2)},"
                    + ",".join(re.findall(r"Li(\d+)E", entry.group(1))) + ">")
            elif name and "spill stores" in line:
                spill = re.findall(r"(\d+) bytes spill", line)
                out.setdefault(name, {})["spill_bytes"] = [int(x)
                                                           for x in spill]
            elif name and "Used" in line:
                out.setdefault(name, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    return out


def child() -> None:
    """Measure the variant whose package is on sys.path."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels import matmul_kernels as K

    def randn(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal(shape) * shape[-1] ** -0.25
        return torch.from_numpy(a).to("cuda", getattr(torch, dtype))

    def ms(fn):
        return statistics.median(autotune.device_times_us(fn, 5)) / 1e3

    def check(got, want, rtol):
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        peak = want.double().abs().max().item()
        if not torch.isfinite(got).all() or err > rtol * peak:
            raise AssertionError(f"error {err:.3e} over peak {peak:.3e}")
        return err / peak

    _build.load()
    rows = {"ptxas": ptxas(_build.CSRC)}
    tile64 = dict(block_m=64, block_n=64, block_k=32)
    for a_shape, b_shape, blocks in K1_CASES:
        a, b = randn(a_shape, "float32", 1), randn(b_shape, "float32", 2)
        kw = dict(zip(("block_m", "block_n", "block_k"), blocks))
        got = K.matmul_cuda(a, b, **kw)
        rel = check(got, K.matmul_plain(a, b, **kw), 1e-4)
        m, k = a_shape[-2:]
        flops = 2 * m * k * b_shape[-1] * (a_shape[0] if len(a_shape) == 3
                                           else 1)
        rows[f"k1 f32 {a_shape}@{b_shape} {blocks}"] = dict(
            ms=ms(lambda: K.matmul_cuda(a, b, **kw)), rel_to_peak=rel,
            bound_ms=flops / FMA_FLOPS * 1e3,
            bits_equal_tile64=bool(torch.equal(
                got, K.matmul_cuda(a, b, **tile64))),
            library_ms=ms(lambda: torch.matmul(a, b)))
    picked = K.square_panel_grid
    for shape, dtype, blocks, grids in K3_CASES:
        a = randn(shape, dtype, 3)
        kw = dict(zip(("block_m", "block_n", "block_k"), blocks))
        rtol = 1e-4
        got = K.square_cuda(a, **kw)
        launch = dict(K.last_launch)
        rel = check(got, K.square_plain(a, **kw), rtol)
        if launch["kernel"] != "square_panel":
            raise AssertionError(f"{shape} {dtype} went to {launch}")
        row = rows[f"k3 {dtype} {shape}"] = dict(
            ms=ms(lambda: K.square_cuda(a, **kw)), rel_to_peak=rel,
            grid=launch, k1_ms=ms(lambda: K.matmul_cuda(a, a, **kw)),
            library_ms=ms(lambda: torch.matmul(a, a)), other_grids_ms={})
        for grid in grids:
            K.square_panel_grid = lambda p, batch, dt, tile, g=grid: g
            check(K.square_cuda(a, **kw), K.square_plain(a, **kw), rtol)
            row["other_grids_ms"][str(grid)] = ms(
                lambda: K.square_cuda(a, **kw))
        K.square_panel_grid = picked
    print(json.dumps(rows), flush=True)


def main() -> int:
    if "--child" in sys.argv:
        child()
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None,
                        help="directory for the variants' copies (default: "
                        "a temporary one, removed at the end)")
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep_fma_rings.py needs a CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else Path(
        tempfile.mkdtemp(prefix="fma-rings-"))
    failed = 0
    try:
        for name in args.variants.split(","):
            k1_stages, panel_bk, panel_stages, tile128 = VARIANTS[name]
            pkg = out / name / "repro_torch"
            shutil.rmtree(pkg, ignore_errors=True)
            shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
                "_build", "__pycache__"))
            rewrite(pkg, k1_stages, panel_bk, panel_stages, tile128)
            env = dict(os.environ, PYTHONPATH=str(pkg.parent),
                       REPRO_TORCH_AUTOTUNE_CACHE=str(out / name / "at.json"))
            done = subprocess.run([sys.executable, __file__, "--child"],
                                  env=env, capture_output=True, text=True)
            if done.returncode:
                failed += 1
                print(json.dumps({"variant": name, "error":
                                  done.stderr[-2000:]}), flush=True)
                continue
            print(json.dumps({"variant": name, "k1_stages": k1_stages,
                              "k3_bk": panel_bk, "k3_stages": panel_stages,
                              "k1_tile128": tile128,
                              **json.loads(done.stdout.splitlines()[-1])}),
                  flush=True)
    finally:
        if not args.out:
            shutil.rmtree(out, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
