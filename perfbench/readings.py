#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from.

    python3 perfbench/readings.py --workload matpow-f32.large \\
        --seeds 1,2,3 --seconds 3 --control-seeds 4,5,6

From the root of a checkout, on the card(s) the cell asks for, in one
process (on a mesh, one a rank) so the set-up is paid once. For each of
``--seeds`` it runs the cell as ``run.py`` does, with a ``--seconds``
window, and prints the numbers it checked. For each of
``--control-seeds`` it makes the operands and the checked requests as a
run with that seed would (each client's first sampled requests, and the
longest), puts the reference one precision below the configuration's in
the program's place (``ops.<op>.Op.control``: TF32 for float32, float32
for float64) and prints the same numbers. One JSON line each.
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

#: Requests of each client's stream the control's sample is drawn from.
CONTROL_REQUESTS = 64


def control_samples(op, mix: dict, seed: int) -> list:
    """The requests a run with ``seed`` would check, answered by the
    control: each client's first ``sample_cap`` sampled requests among its
    first ``CONTROL_REQUESTS``, and the longest of all those."""
    from perfbench.harness.traffic import client_requests
    picked, longest = [], None
    for c in range(mix["clients"]):
        stream = client_requests(mix, seed, c)
        reqs = [next(stream) for _ in range(CONTROL_REQUESTS)]
        picked += [r for r in reqs if r.sampled][:mix["sample_cap"]]
        top = max(reqs, key=op.weight)
        if longest is None or op.weight(top) > op.weight(longest):
            longest = top
    if all(r is not longest for r in picked):
        picked.append(longest)
    return [(r, op.control(r)) for r in picked]


def _emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def _program(cell, seeds, seconds, device, mesh=None, rank=0, world=1):
    from perfbench.harness import cell as cell_run
    for seed in seeds:
        t0 = time.perf_counter()
        res = cell_run.run(cell, seed, seconds, False, device, t0,
                           mesh=mesh, rank=rank, world=world)
        if rank == 0:
            _emit({"workload": cell.name, "kind": "program", "seed": seed,
                   "correct": res["correct"], "checks": res["checks"],
                   "requests_per_s": res["metrics"].get(
                       "requests_per_s", {}).get("value")})


def _control(cell, seeds, device):
    import importlib
    import torch
    for seed in seeds:
        op = importlib.import_module(
            f"perfbench.ops.{cell.config['op']}").Op(
                cell.config, cell.mix, seed, device)
        samples = control_samples(op, cell.mix, seed)
        _emit({"workload": cell.name, "kind": "control", "seed": seed,
               "checked": len(samples), "numbers": op.numbers(samples)})
        del op, samples
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    import torch
    from perfbench.harness import mesh, spec
    cell = spec.load_cell(args.workload)
    if seeds and torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA devices", file=sys.stderr)
        return 1
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(tmp / "autotune.json")
        if cell.chips == 1 or not seeds:
            device = torch.device("cuda", 0)
            _program(cell, seeds, args.seconds, device)
            _control(cell, controls, device)
            return 0
        rdzv = args.rdzv or f"file://{tmp}/rdzv"
        children = []
        if args.rank == 0:
            children = mesh.spawn(
                [sys.executable, str(Path(__file__).resolve()),
                 "--workload", args.workload, "--seeds", args.seeds,
                 "--seconds", str(args.seconds)], cell.chips, rdzv)
        try:
            mesh.session(args.rank, cell.chips, rdzv, cell.config["mesh"],
                         lambda m, dev: _program(cell, seeds, args.seconds,
                                                 dev, m, args.rank,
                                                 cell.chips))
        finally:
            mesh.reap(children)
        if args.rank == 0:
            _control(cell, controls, torch.device("cuda", 0))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
