"""Render roofline tables from a dry run's records.

The port of the reference's ``analysis/summarize.py``. It reads the
records of either package: the port's (``live_bytes_per_device``,
``fits_80gb``, from ``experiments/dryrun_torch``) and the reference's
(``live_bytes_tpu``, ``fits_16gb``).

    PYTHONPATH=src python -m repro_torch.analysis.summarize \
        [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def load(dir_: Path):
    cells = {}
    for f in sorted(dir_.glob("*.json")):
        r = json.loads(f.read_text())
        parts = f.stem.split("__")
        variant = parts[3] if len(parts) > 3 else "baseline"
        cells[(r.get("arch", parts[0]), r.get("shape", parts[1]),
               r.get("mesh", parts[2]), variant)] = r
    return cells


def fmt_ms(s):
    return f"{s*1e3:.1f}"


def _live(r):
    return r.get("live_bytes_tpu", r.get("live_bytes_per_device", 0))


def _fits(r):
    return r.get("fits_16gb", r.get("fits_80gb"))


def roofline_table(cells, mesh="single", variant="baseline"):
    lines = [
        "| arch | shape | dom | compute ms | memory ms | coll ms | "
        "roofline frac | useful | live GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, m, v), r in sorted(cells.items()):
        if m != mesh or v != variant:
            continue
        if r.get("status") == "SKIP":
            lines.append(f"| {arch} | {shape} | SKIP | - | - | - | - | - | "
                         f"- | - |")
            continue
        if r.get("status") != "OK":
            lines.append(f"| {arch} | {shape} | FAIL | - | - | - | - | - | "
                         f"- | - |")
            continue
        dom_t = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom_t if dom_t else 0
        lines.append(
            f"| {arch} | {shape} | {r['dominant'][:4]} "
            f"| {fmt_ms(r['compute_s'])} | {fmt_ms(r['memory_s'])} "
            f"| {fmt_ms(r['collective_s'])} | {frac:.2f} "
            f"| {r['useful_ratio']:.2f} | {_live(r)/2**30:.1f} "
            f"| {'Y' if _fits(r) else 'N'} |")
    return "\n".join(lines)


def multi_pod_table(cells, variant="baseline"):
    lines = [
        "| arch | shape | single | multi | coll bytes ratio (multi/single) |",
        "|---|---|---|---|---|",
    ]
    seen = set()
    for (arch, shape, m, v), r in sorted(cells.items()):
        if v != variant or (arch, shape) in seen:
            continue
        seen.add((arch, shape))
        s = cells.get((arch, shape, "single", variant), {})
        mu = cells.get((arch, shape, "multi", variant), {})
        st = s.get("status", "-")
        mt = mu.get("status", "-")
        ratio = "-"
        if st == "OK" and mt == "OK" and s.get("collective_bytes"):
            ratio = f"{mu['collective_bytes']/s['collective_bytes']:.2f}"
        lines.append(f"| {arch} | {shape} | {st} | {mt} | {ratio} |")
    return "\n".join(lines)


def variants_table(cells, arch, shape, mesh="single"):
    lines = [
        "| variant | dom | compute ms | memory ms | coll ms | live GiB |",
        "|---|---|---|---|---|---|",
    ]
    for (a, s, m, v), r in sorted(cells.items()):
        if (a, s, m) != (arch, shape, mesh) or r.get("status") != "OK":
            continue
        lines.append(f"| {v} | {r['dominant'][:4]} "
                     f"| {fmt_ms(r['compute_s'])} | {fmt_ms(r['memory_s'])} "
                     f"| {fmt_ms(r['collective_s'])} "
                     f"| {_live(r)/2**30:.1f} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--cell", default=None,
                    help="arch:shape — print the variants table for a cell")
    args = ap.parse_args(argv)
    cells = load(Path(args.dir))
    if args.cell:
        arch, shape = args.cell.split(":")
        print(variants_table(cells, arch, shape, args.mesh))
        return
    print(roofline_table(cells, args.mesh, args.variant))
    print()
    print(multi_pod_table(cells, args.variant))


if __name__ == "__main__":
    main()
