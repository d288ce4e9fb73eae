#!/usr/bin/env python3
"""Hold the dry run's depth extrapolation against a count at full depth.

    PYTHONPATH=src python3 tools/dryrun_depth_check.py \
        qwen3-1.7b:train_4k mamba2-130m:train_4k [--mesh single]

For each ``arch:shape`` cell, counts one step on a fake production mesh
(meta tensors, no device) twice: through ``launch.dryrun.count_cell``
(traced at ``dryrun.TRACED`` depths and extrapolated) and as a whole at the
config's depth. Prints one JSON line a cell: seconds of each, whether the
FLOPs and ``dense_mm`` calls are equal, and the relative gaps of the
bytes, collective bytes and peak live bytes, with the collective counts
of both.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.analysis import op_cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def _rel(a, b) -> float:
    return (a - b) / b if b else 0.0


def check(arch: str, shape: str, mesh_name: str) -> dict:
    world, multi = dryrun.MESHES[mesh_name]
    with dryrun.fake_group(world):
        mesh = make_production_mesh(multi_pod=multi, device="cuda")
        t0 = time.perf_counter()
        got, _, _ = dryrun.count_cell(arch, shape, mesh)
        t1 = time.perf_counter()
        fn, args, _, _ = dryrun.build_cell(arch, shape, mesh)
        want = op_cost.count(fn, *args)
        t2 = time.perf_counter()
    return {"cell": f"{arch}:{shape}:{mesh_name}",
            "traced_depths": list(got.depths), "depth": got.depth,
            "extrapolated_s": round(t1 - t0, 1),
            "full_depth_s": round(t2 - t1, 1),
            "flops_equal": got.flops == want.flops,
            "dense_mm_equal": got.dense_mm_calls == want.dense_mm_calls,
            "bytes_rel": _rel(got.bytes, want.bytes),
            "collective_bytes_rel": _rel(got.collective_bytes,
                                         want.collective_bytes),
            "peak_rel": _rel(got.peak_bytes, want.peak_bytes),
            "collective_counts": {
                k: [got.collectives[k]["count"],
                    want.collectives.get(k, {}).get("count")]
                for k in got.collectives}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+", help="arch:shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    for cell in args.cells:
        arch, shape = cell.split(":")
        print(json.dumps(check(arch, shape, args.mesh)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
