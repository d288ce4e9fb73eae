#!/usr/bin/env python3
"""Sweep the f32 K2 (csrc/gemm.cuh) and the FMA K5 (csrc/attention.cuh) on
one GPU.

    python3 tools/sweep_fma_k2_k5.py [--out DIR] [--variants NAME,...]

K2's thread tiles and K slices (the ``REPRO_WHOLE_F32`` lines) and K5's ring
slots (the fourth number of the ``REPRO_ATTN_TILE`` lines), threads a block
(``kThreads``) and score-loop unrolling are compile-time, so each variant
is a build of its own. For every variant in ``VARIANTS`` this script copies
``src/repro_torch`` into ``DIR/<variant>``, rewrites those lines in the
``.cuh`` files (the Python tables are read from them),
and in a child process on that copy: builds the kernels (first use), prints
``nvcc -Xptxas -v``'s registers and spills for K2 and the f32 / f64 K5,
checks each case against its plain version and times it (device time,
``autotune.device_times_us``: CUDA-event medians over replays of a CUDA
graph of back-to-back calls). K2 runs at the grid ``square_whole_grid``
picks and at the other grids of ``K2_CASES``, beside K1 and the library on
the same operand; K5 at each block of ``K5_CASES``. One JSON line per
variant on stdout, then one line with the card's name and power limit.
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

BASE_K2 = {16: (4, 8, 16), 32: (8, 4, 4), 64: (8, 8, 4)}
#: name -> what the variant changes from the tree: ``k2`` K2's {tile: (R,
#: C, KS)}; ``stages`` every K5 tile's ring slots; ``threads`` K5's threads
#: a block (``kThreads``) with ``tiles`` the K5 tile lines it instantiates
#: (D, BQ, BK, STAGES) in place of the tree's; ``unroll`` the unroll factor
#: of K5's score loop.
VARIANTS = {
    "base": {},
    "k2_fewer_slices_k5_two_slots": {
        "k2": {16: (4, 8, 8), 32: (8, 4, 2), 64: (8, 8, 2)}, "stages": 2},
    "k2_more_slices": {"k2": {16: (4, 8, 32), 32: (8, 4, 8), 64: (8, 8, 8)}},
    "k5_threads128": {"threads": 128, "tiles": [
        (128, 64, 32, 3), (128, 64, 64, 3), (128, 64, 128, 2)]},
    "k5_threads512": {"threads": 512, "tiles": [
        (128, 64, 32, 3), (128, 64, 64, 3), (128, 64, 128, 2),
        (128, 128, 32, 3), (128, 128, 64, 3)]},
    "k5_unroll4": {"unroll": 4},
    "k5_unroll1": {"unroll": 1},
}

#: K2 cases: (shape, grids (tile, groups) timed beside the rule's).
K2_CASES = [((128, 128), [(16, 32), (32, 16)]),
            ((192, 192), [(16, 144), (16, 48), (32, 36)]),
            ((224, 224), [(16, 132), (32, 49)]),
            ((32, 128, 128), [(32, 4), (32, 16), (64, 1)])]
#: K5 cases: (name, leading dims, Sq, Skv, d, dtype, blocks timed).
K5_CASES = [("prefill_f32", (16,), 4096, 4096, 128, "float32",
             [(128, 64), (128, 32), (64, 64), (64, 128)]),
            ("decode_f32", (16,), 128, 4096, 128, "float32",
             [(128, 64), (128, 32), (64, 64), (64, 128)]),
            ("decode_f64", (16,), 128, 4096, 128, "float64", [(128, 64)])]


def rewrite(pkg: Path, variant: dict) -> None:
    """Make the variant's changes in a copy of the package."""
    csrc = pkg / "kernels" / "csrc"
    whole = variant.get("k2", BASE_K2)
    gemm = csrc / "gemm.cuh"
    gemm.write_text(re.sub(
        r"^(\s*)REPRO_WHOLE_F32\((\d+), \d+, \d+, \d+\)$",
        lambda m: "{}REPRO_WHOLE_F32({}, {}, {}, {})".format(
            m.group(1), m.group(2), *whole[int(m.group(2))]),
        gemm.read_text(), flags=re.M))
    py = pkg / "kernels" / "matmul.py"
    py.write_text(re.sub(r"^WHOLE_F32 = \{.*?\}", f"WHOLE_F32 = {whole!r}",
                         py.read_text(), flags=re.M))
    attn = csrc / "attention.cuh"
    src = attn.read_text()
    if "stages" in variant:
        src = re.sub(r"^(\s*REPRO_ATTN_TILE\(\d+, \d+, \d+, )\d+\)",
                     rf"\g<1>{variant['stages']})", src, flags=re.M)
    if "threads" in variant:
        src = re.sub(r"^constexpr int kThreads = \d+;",
                     f"constexpr int kThreads = {variant['threads']};", src,
                     flags=re.M)
        lines = "".join(f"  REPRO_ATTN_TILE({', '.join(map(str, t))})\n"
                        for t in variant["tiles"])
        src = re.sub(r"(^\s*REPRO_ATTN_TILE\(\d+, \d+, \d+, \d+\)\n)+",
                     lines, src, flags=re.M)
    if "unroll" in variant:
        kernel = src.index("flash_attention_kernel(")
        src = src[:kernel] + src[kernel:].replace(
            "#pragma unroll 2\n", f"#pragma unroll {variant['unroll']}\n")
    attn.write_text(src)


def ptxas(csrc: Path) -> dict:
    """Registers and spill bytes of K2 and the FMA K5 per instantiation."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = {}
    for unit in ("matmul_f32", "attention_f32", "attention_f64"):
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
                    r"(square_whole_kernel|flash_attention_kernelI(\w))",
                    entry.group(1))
                name = None if kernel is None else (
                    f"{unit}:{kernel.group(1)}<"
                    + ",".join(re.findall(r"Li(\d+)E", entry.group(1)))
                    + ">")
            elif name and "spill stores" in line:
                out.setdefault(name, {})["spill_bytes"] = int(
                    re.search(r"(\d+) bytes spill stores", line).group(1))
            elif name and "Used" in line:
                out.setdefault(name, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
    return out


def child() -> None:
    """Measure the variant whose package is on sys.path."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, autotune, ref
    from repro_torch.kernels import attention_kernels as A
    from repro_torch.kernels import matmul_kernels as K

    def randn(shape, dtype, seed):
        rng = np.random.default_rng(seed)
        a = rng.standard_normal(shape) * shape[-1] ** -0.25
        return torch.from_numpy(a).to("cuda", getattr(torch, dtype))

    def ms(fn):
        return statistics.median(autotune.device_times_us(fn, 5)) / 1e3

    def check(err, what):
        if not err <= 1e-4:
            raise AssertionError(f"{what}: error {err:.3e}")
        return err

    def peak_rel(got, want):
        torch.cuda.synchronize()
        return ((got.double() - want.double()).abs().max()
                / want.double().abs().max()).item()

    _build.load()
    rows = {"ptxas": ptxas(_build.CSRC)}
    picked = K.square_whole_grid
    kw = dict(block_m=32, block_n=32, block_k=16)
    for shape, grids in K2_CASES:
        a = randn(shape, "float32", 3)
        want = K.square_plain(a, **kw)
        got = K.square_cuda(a, **kw)
        launch = dict(K.last_launch)
        row = rows[f"k2 {shape}"] = dict(
            grid=launch, ms=ms(lambda: K.square_cuda(a, **kw)),
            rel_to_peak=check(peak_rel(got, want), f"k2 {shape}"),
            k1_ms=ms(lambda: K.matmul_cuda(a, a, **kw)),
            library_ms=ms(lambda: torch.matmul(a, a)), other_grids_ms={})
        for grid in grids:
            p = shape[-1]
            if p % grid[0] or K.whole_fma_smem_bytes(p, *grid) \
                    > K.SMEM_PER_BLOCK:
                continue
            K.square_whole_grid = lambda p, b, d, g=grid: g
            check(peak_rel(K.square_cuda(a, **kw), want), f"k2 {grid}")
            row["other_grids_ms"][str(grid)] = ms(
                lambda: K.square_cuda(a, **kw))
        K.square_whole_grid = picked
    for name, lead, sq, skv, d, dtype, blocks in K5_CASES:
        rng = np.random.default_rng(5)
        q, k, v = (torch.from_numpy(rng.standard_normal((*lead, s, d)))
                   .to("cuda", getattr(torch, dtype)) for s in (sq, skv, skv))
        want = A.flash_attention_plain(q, k, v, causal=True)
        row = rows[f"k5 {name}"] = {}
        for bq, bk in blocks:
            if A.kernel_tile(bq, bk, d, q.dtype) is None:
                continue
            got = A.flash_attention(q, k, v, causal=True, block_q=bq,
                                    block_k=bk)
            torch.cuda.synchronize()
            launch = dict(A.last_launch)
            row[f"{bq}x{bk}"] = dict(
                tile=launch["tile"], splits=launch["splits"],
                stages=A.ATTN_FMA_STAGES[(d, *launch["tile"])],
                rel_to_row=check(ref.row_relative_error(got, want),
                                 f"k5 {name} {bq}x{bk}"),
                ms=ms(lambda: A.flash_attention(q, k, v, causal=True,
                                                block_q=bq, block_k=bk)))
        del q, k, v, want
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
        print("sweep_fma_k2_k5.py needs a CUDA device", file=sys.stderr)
        return 1
    out = Path(args.out) if args.out else Path(
        tempfile.mkdtemp(prefix="fma-k2-k5-"))
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
                                  done.stderr[-2000:]}), flush=True)
                continue
            print(json.dumps({"variant": name,
                              "changes": {k: str(v) for k, v in
                                          VARIANTS[name].items()},
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
