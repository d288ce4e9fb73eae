"""Cells cut to a size the CPU runs in seconds, for the rehearsals."""

from __future__ import annotations

import time

import torch

from perfbench.harness import cell as cell_run
from perfbench.harness import spec

#: Per cell: the sizes, clients and chain blocks of the CPU rehearsal.
SMALL = {"matpow-f32.large": {"sizes": [96]},
         "markov-f64.ncd": {"sizes": [64]},
         "matpow-f32-2x2.solo": {"sizes": [64]}}

ONE_CHIP = ("matpow-f32.large", "markov-f64.ncd")


def small_cell(name: str):
    c = spec.load_cell(name)
    c.mix = dict(c.mix, pool=2, sample=0.5, **SMALL[name])
    if c.config["op"] == "markov":
        c.config = dict(c.config, chain=dict(c.config["chain"], blocks=4))
    return c


def tune_for_cpu(monkeypatch, tmp_path):
    """A fresh tuning cache in which n = 96 takes the fastmm route and n =
    64 the sharded one, as the full sizes do on the card."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    autotune.record_dispatch_thresholds(16, 32, backend="cpu")
    autotune.record_fastmm(32, 2, backend="cpu")


def run_small(name: str, traced: bool = False, seconds: float = 1.0,
              seed: int = 2_718_281_828_459):
    c = small_cell(name)
    return cell_run.run(c, seed, seconds, traced, torch.device("cpu"),
                        time.perf_counter())
