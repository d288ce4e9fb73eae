#!/usr/bin/env python3
"""Sweep the grids and rings of the fp64 K2 / K3 (csrc/gemm_dmma.cuh) on one
GPU.

    python3 tools/sweep_dmma_squares.py [--out DIR] [--variants NAME,...]

K2 (``square_whole_dmma``) and K3 (``square_panel_dmma``) pick their output
tiles and grids by a cost model (``matmul.square_whole_grid`` /
``square_panel_grid``); this script times the grid each rule picks beside
the other grids of the instantiated tiles, K1 on the fp64 tensor cores on
the same operand (tiles 32 and 64) and the library's ``torch.matmul``, at
the f64 tiers' sizes — K2 from 64² to 160² and two stacks, K3 from 192² to
the demotion edge (384² at the chain's 64-wide tile), 512² on 32-row panels
(past the edge) and the stacked chain's ``(64, 256, 256)``. Every timed
launch is first checked against its plain version (1e-12 of the peak).

A variant of ``VARIANTS`` is a build of its own: the package is copied
into ``DIR/<variant>``, the variant's lines of ``gemm_dmma.cuh`` are
replaced, and a child process measures that copy and prints ``nvcc
-Xptxas -v``'s registers and spills for the fp64 kernels. (Variants that
measured K3's rings, a last partial K step and K2's per-K-step landing are
in PERF.md §6.) One JSON line per variant on stdout, then the card's name and
power limit. Times are device times (``autotune.device_times_us``:
CUDA-event medians over replays of a CUDA graph of back-to-back calls).
Needs a CUDA device and ``nvcc``; imports ``repro_torch`` (the copy's)
only.
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

#: name -> (old, new) replacements in gemm_dmma.cuh.
VARIANTS = {
    "table": (),
    # K3 on its 32-deep rings wherever it takes a 64-deep one
    "k3_bk32": (("  REPRO_DMMA_PANEL(16, 32, 64, 3)\n", ""),
                ("  REPRO_DMMA_PANEL(32, 32, 64, 2)\n", "")),
}

#: K2 cases: (shape, other (tile, groups) grids); K3 cases: (shape, chain
#: blocks, other (height, width, groups) grids).
K2_CASES = [((64, 64), [(32, 4), (16, 8)]),
            ((128, 128), [(32, 16), (16, 32), (64, 4), (32, 8)]),
            ((160, 160), [(32, 25), (16, 50)]),
            ((32, 128, 128), [(16, 4), (32, 4), (32, 16)]),
            ((33, 128, 128), [(32, 4), (16, 8)])]
K3_CASES = [((128, 128), (64, 64, 32), [(32, 32, 4), (16, 32, 2)]),
            ((192, 192), (64, 64, 32), [(32, 32, 6), (16, 32, 3)]),
            ((256, 256), (64, 64, 32),
             [(32, 32, 8), (16, 32, 4), (64, 64, 4), (32, 32, 4)]),
            ((320, 320), (64, 64, 32), [(32, 32, 10), (16, 32, 5)]),
            ((384, 384), (64, 64, 32),
             [(16, 32, 4), (16, 32, 12), (32, 32, 12), (64, 64, 6)]),
            ((512, 512), (32, 32, 16), [(16, 32, 16), (32, 32, 16)]),
            ((64, 256, 256), (64, 64, 32), [(64, 64, 1), (64, 64, 2)])]


def rewrite(pkg: Path, edits) -> None:
    """Make the variant's edits in a copy of the package: each replaces
    exactly one place of gemm_dmma.cuh; a ring the edits remove goes from
    ``matmul.DMMA_PANEL_RINGS`` as well."""
    cuh = pkg / "kernels" / "csrc" / "gemm_dmma.cuh"
    src = cuh.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant edit {old!r} matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    cuh.write_text(src)
    rings = {tuple(int(x) for x in m[:3]): int(m[3]) for m in re.findall(
        r"^\s*REPRO_DMMA_PANEL\((\d+), (\d+), (\d+), (\d+)\)", src, flags=re.M)}
    py = pkg / "kernels" / "matmul.py"
    py.write_text(re.sub(r"^DMMA_PANEL_RINGS = \{.*?\}",
                         f"DMMA_PANEL_RINGS = {rings!r}", py.read_text(),
                         flags=re.M | re.S))


def ptxas(csrc: Path) -> dict:
    """Registers and spill bytes of the fp64 kernels per instantiation."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    done = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-I", str(csrc), "-c",
         str(csrc / "matmul_f64.cu"), "-o", os.devnull],
        capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in done.stderr.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = re.search(r"(\w+_dmma_kernel)I", entry.group(1))
            name = None if kernel is None else (
                kernel.group(1) + "<"
                + ",".join(re.findall(r"Li(\d+)E", entry.group(1))) + ">")
        elif name and "spill stores" in line:
            out.setdefault(name, {})["spill_bytes"] = [
                int(x) for x in re.findall(r"(\d+) bytes spill", line)]
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

    def randn(shape, seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal(shape) * shape[-1] ** -0.25
        return torch.from_numpy(a).to("cuda", torch.float64)

    def ms(fn):
        return statistics.median(autotune.device_times_us(fn, 5)) / 1e3

    def checked(run, plain, kernel):
        got = run()
        launch = dict(K.last_launch)
        torch.cuda.synchronize()
        want = plain()
        err = (got - want).abs().max().item()
        peak = want.abs().max().item()
        if launch["kernel"] != kernel or err > 1e-12 * peak:
            raise AssertionError(f"{launch}: error {err:.3e} of {peak:.3e}")
        return dict(ms=ms(run), rel_to_peak=err / peak, **launch)

    def k1_ms(a):
        return {t: ms(lambda: K.matmul_cuda(a, a, block_m=t, block_n=t,
                                            block_k=16))
                for t in K.DMMA_TILES if a.shape[-1] % t == 0}

    _build.load()
    rows = {"ptxas": ptxas(_build.CSRC)}
    for case, (shape, grids) in enumerate(K2_CASES):
        a = randn(shape, case)
        kw = dict(block_m=32, block_n=32, block_k=16)
        run = lambda: K.square_cuda(a, **kw)
        plain = lambda: K.square_plain(a, **kw)
        row = rows[f"k2 {shape}"] = dict(
            picked=checked(run, plain, "square_whole_dmma"), k1_ms=k1_ms(a),
            library_ms=ms(lambda: torch.matmul(a, a)), other_grids={})
        picked = K.square_whole_grid
        for grid in grids:
            K.square_whole_grid = lambda p, batch, dt, g=grid: g
            row["other_grids"][str(grid)] = checked(run, plain,
                                                    "square_whole_dmma")["ms"]
        K.square_whole_grid = picked
    for case, (shape, blocks, grids) in enumerate(K3_CASES):
        a = randn(shape, 10 + case)
        kw = dict(zip(("block_m", "block_n", "block_k"), blocks),
                  smem_limit=0)
        run = lambda: K.square_cuda(a, **kw)
        plain = lambda: K.square_plain(a, **kw)
        row = rows[f"k3 {shape}"] = dict(
            picked=checked(run, plain, "square_panel_dmma"), k1_ms=k1_ms(a),
            library_ms=ms(lambda: torch.matmul(a, a)), other_grids={})
        picked = K.square_panel_grid
        for grid in grids:
            K.square_panel_grid = lambda p, batch, dt, tile, g=grid: g
            row["other_grids"][str(grid)] = checked(run, plain,
                                                    "square_panel_dmma")["ms"]
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
        print("sweep_dmma_squares.py needs a CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else Path(
        tempfile.mkdtemp(prefix="dmma-squares-"))
    failed = 0
    try:
        for name in args.variants.split(","):
            pkg = out / name / "repro_torch"
            shutil.rmtree(pkg, ignore_errors=True)
            shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
                "_build", "__pycache__"))
            rewrite(pkg, VARIANTS[name])
            env = dict(os.environ, PYTHONPATH=str(pkg.parent),
                       REPRO_TORCH_AUTOTUNE_CACHE=str(out / name / "at.json"))
            done = subprocess.run([sys.executable, __file__, "--child"],
                                  env=env, capture_output=True, text=True)
            if done.returncode:
                failed += 1
                print(json.dumps({"variant": name, "error":
                                  done.stderr[-3000:]}), flush=True)
                continue
            print(json.dumps({"variant": name, "edits": VARIANTS[name],
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
