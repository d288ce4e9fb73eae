#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card(s) of this machine.

    python3 perfbench/run.py --workload matpow-f32.large --seed 7 \\
        --seconds 20 --trace 0

From the root of a checkout. Sets up the cell (operands from the seed on
the card, the engine started and warmed), measures for ``--seconds``
seconds, checks the answers of the window against the plain reference in
``perfbench/reference/``, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with ``--trace
1``), ``device`` and, traced, ``breakdown``; the numbers checked, each
beside its limit, come last in that line (``checks``) and as the last
lines of standard error. Exits non-zero, with no result, without CUDA or
with fewer cards than the cell asks for, when the port is not in the
checkout, or when a module of JAX or of the JAX package ``repro`` was
loaded, in this process or on any rank of the mesh. On a cell of several chips this process is rank 0 and starts the
other ranks itself.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Build and kernel caches, at fixed paths inside the checkout.
CACHE = ROOT / ".perfbench_cache"


def _environment(tmp: Path) -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # A fresh tuning cache every run: routes and tiles are the program's
    # defaults, never what an earlier run recorded.
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp / "autotune.json")


def _fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from perfbench.harness import spec
    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, OSError) as exc:
        return _fail(f"cannot load workload {args.workload!r}: {exc}")
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        _environment(tmp)
        return _run(args, cell, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, cell, tmp: Path) -> int:
    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} CUDA devices, "
                     f"found {torch.cuda.device_count()}")
    try:
        import repro_torch
    except ImportError as exc:
        return _fail(f"the port is not in this checkout: {exc}")
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        return _fail(f"repro_torch comes from {repro_torch.__file__}, not "
                     f"from this checkout's src/")
    from perfbench.harness import cell as cell_run
    from perfbench.harness import mesh

    traced = bool(args.trace)
    if cell.chips == 1:
        result = cell_run.run(cell, args.seed, args.seconds, traced,
                              torch.device("cuda", 0), T_START)
    else:
        rdzv = args.rdzv or f"file://{tmp}/rdzv"
        children = []
        if args.rank == 0:
            children = mesh.spawn(
                [sys.executable, str(Path(__file__).resolve()),
                 "--workload", args.workload, "--seed", str(args.seed),
                 "--seconds", str(args.seconds), "--trace", str(args.trace)],
                cell.chips, rdzv)
        try:
            result = mesh.session(
                args.rank, cell.chips, rdzv, cell.config["mesh"],
                lambda m, dev: cell_run.run(cell, args.seed, args.seconds,
                                            traced, dev, T_START, mesh=m,
                                            rank=args.rank,
                                            world=cell.chips))
        finally:
            mesh.reap(children)
        if args.rank != 0:
            return 0
    return report(result)


def report(result: dict) -> int:
    """Print the result line and the checks, or, where this process or
    another rank of the run loaded a module of JAX or of the JAX package,
    name them on standard error, print no result and return 1."""
    from perfbench.harness.cell import forbidden_modules
    found = dict(result.pop("forbidden_elsewhere", {}))
    own = forbidden_modules()
    if own:
        found[0] = own
    if found:
        return _fail("modules of JAX or of the JAX package were loaded: "
                     + "; ".join(f"rank {r}: {found[r]}"
                                 for r in sorted(found)))
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {name} = {c['value']!r} (limit {rel} {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
