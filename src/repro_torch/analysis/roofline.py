"""Three-term roofline from a dry run's counts (no hardware).

The port of the reference's ``analysis/roofline.py``. Terms (seconds), per
rank, for one step:
    compute    = FLOPs_per_rank / PEAK_FLOPS
    memory     = bytes_per_rank / HBM_BW
    collective = wire bytes over NVLink / NVLINK_BW
                 + wire bytes over the network / NETWORK_BW

The counts come from ``analysis.op_cost`` (one step of the cell counted op
by op on each rank's local shards), not from a compiled program. Each
collective kind gets a wire-traffic multiplier for its ring
implementation (``wire_bytes``, shared by ``parse_collectives`` and the op
counter):

    all-gather       result * (g-1)/g           (receives the other shards)
    all-reduce       2 * result * (g-1)/g       (reduce-scatter + all-gather)
    reduce-scatter   result * (g-1)              (result is the scattered shard)
    all-to-all       result * (g-1)/g
    collective-permute  result                   (one send + one recv)

Hardware constants: one NVIDIA H100 SXM, from NVIDIA's data sheet (dense
rates, no sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3; NVLink 4 at
450 GB/s each way for a group that lies inside one 8-GPU node; one 400 Gb/s
NDR InfiniBand link a GPU (50 GB/s) for a group that spans nodes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

__all__ = ["HW", "RooflineReport", "analyze", "parse_collectives",
           "model_flops", "wire_bytes"]

PEAK_FLOPS = 989e12          # bf16 dense, per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s each way per GPU, inside a node
NETWORK_BW = 50e9            # bytes/s per GPU (400 Gb/s NDR), across nodes
GPUS_PER_NODE = 8

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
      "network_bw": NETWORK_BW, "gpus_per_node": GPUS_PER_NODE}

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+)\[([\d,]*)\][^\s]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def wire_bytes(kind: str, size: float, g: int) -> float:
    """Bytes one rank sends for a collective of ``kind`` whose result on
    that rank is ``size`` bytes, over a group of ``g`` ranks (ring)."""
    if kind == "all-gather":
        return size * (g - 1) / g
    if kind == "all-reduce":
        return 2 * size * (g - 1) / g
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-to-all":
        return size * (g - 1) / g
    return size                  # collective-permute


def parse_collectives(hlo_text: str, n_devices: int) -> Dict[str, dict]:
    """Sum per-device wire bytes by collective kind from post-SPMD HLO."""
    out: Dict[str, dict] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        tuple_body, dtype, dims, kind = m.groups()
        if tuple_body is not None:   # tuple result (e.g. -start ops)
            size = sum(_shape_bytes(d, s)
                       for d, s in _SHAPE_RE.findall(tuple_body))
            # tuple repeats operand+result; halve to approximate result only
            size //= 2
        else:
            size = _shape_bytes(dtype, dims)
        g = _group_size(line, n_devices)
        if g <= 1:
            continue
        slot = out.setdefault(kind, {"count": 0, "bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += wire_bytes(kind, size, g)
    return out


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the whole step (global).

    train:   6 * N_active * tokens   (fwd 2ND + bwd 4ND)
    prefill: 2 * N_active * tokens
    decode:  2 * N_active * batch    (one token per sequence)
    """
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collectives: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_ratio: float
    memory_stats: Optional[dict] = None

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(*, arch: str, shape_name: str, mesh_name: str, n_devices: int,
            cost, cfg, shape,
            memory_stats: Optional[dict] = None) -> RooflineReport:
    """The roofline of one cell from ``cost`` (an ``op_cost.OpCost`` of one
    step on one rank, at the config's depth). ``flops_per_device`` counts
    everything the rank computes, the remat recomputation and the work
    every rank of a tp group repeats included; ``model_flops_global`` is
    the useful work alone, so ``useful_ratio`` is the share of the counted
    work that a step needs."""
    flops = float(cost.flops)
    byts = float(cost.bytes)
    colls = cost.collectives
    cbytes = cost.collective_bytes
    net = sum(c["network_bytes"] for c in colls.values())
    memory_stats = dict(memory_stats or {})
    memory_stats.update(peak_live_bytes=cost.peak_bytes,
                        dense_mm_calls=cost.dense_mm_calls,
                        traced_depths=list(cost.depths),
                        network_collective_bytes=net)

    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = (cbytes - net) / NVLINK_BW + net / NETWORK_BW
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", collective_s), key=lambda kv: kv[1])[0]

    mf = model_flops(cfg, shape)
    useful = mf / (flops * n_devices) if flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes=cbytes, collectives=colls,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dom, model_flops_global=mf, useful_ratio=useful,
        memory_stats=memory_stats)
