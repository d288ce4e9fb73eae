"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``configs/<file>`` as the configuration's
entry gives it), a traffic mix (``traffic/<traffic>.json``) and has its
correctness limits in ``limits/<cell>.json``; a per-layer metric is
``metrics/<name with dots as underscores>.py`` with a ``read(readings)``
function. Adding any of them takes new files and new entries only.

A cell reports the end-to-end metrics whose ``workloads`` name it (all
where the key is absent), and every per-layer metric whose reader finds
something to read in it: a reader returns None where it does not apply,
so a new cell gets each existing per-layer metric without an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import re
from pathlib import Path

__all__ = ["ROOT", "BENCH", "Cell", "load_bench", "load_cell",
           "metric_reader", "NAME_RE", "UNIT_RE"]

#: The checkout (the directory that holds ``BENCHMARK.json``).
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
HERE = Path(__file__).resolve().parents[1]

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    mix: dict             # the traffic mix's file
    limits: dict          # limits/<cell>.json: number -> {"limit": ...}
    end_to_end: list      # BENCHMARK.json metrics this cell reports
    per_layer: list       # every per-layer metric: its reader decides


def load_bench(path: Path = BENCH) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_bench() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(ROOT / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, int(w["chips"]), config, mix, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                list(bench["per_layer"]))


def metric_reader(name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    module = importlib.import_module(
        "perfbench.metrics." + name.replace(".", "_").replace("-", "_"))
    return module.read
