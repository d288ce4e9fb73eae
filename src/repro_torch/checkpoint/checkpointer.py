"""Fault-tolerant npz-shard checkpointer (no external deps).

The port of the reference's ``checkpoint/checkpointer.py``, with the same
protocol and the same files, so a checkpoint crosses between the packages:

  * layout — arrays are saved in host form keyed by their tree path (dict
    keys joined by ``/``; a ``QTensor`` leaf by its children ``0`` (q) and
    ``1`` (scale), as the reference's pytree class flattens), in
    ``shard_NNNNN.npz`` files beside a ``manifest.json``;
  * atomic — writes go to ``step_N.tmp-<nonce>/`` and one ``os.rename``
    publishes ``step_N/``; a crash mid-save never corrupts the latest good
    checkpoint;
  * integrity — the manifest holds each shard's sha256; restore refuses a
    shard that does not match;
  * retention — the ``keep`` newest checkpoints are kept, older ones pruned
    only AFTER the new one is durable;
  * async — ``save(..., blocking=False)`` copies the tree to the host
    before it returns and writes it from a background thread;
  * elastic — a tree of DTensors is saved whole (each leaf gathered, so
    the files name no mesh: every rank calls ``save``, rank 0 writes, and
    a blocking save ends with a barrier), and ``shardings=`` restores it
    onto any mesh (the reference's ``load_pytree(..., shardings=)``).

bfloat16. numpy has no bfloat16 here (no ``ml_dtypes``): a bf16 leaf is
written as its ``uint16`` bits with ``"bfloat16"`` in the manifest, and on
read the manifest's dtype decides — the reference's bf16 arrays (which
load from npz as 2-byte void) are viewed the same way. The reference casts
what it reads with ``astype``, so a bf16 leaf written here does not restore
there; fp32 and integer leaves cross both ways.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import is_dtensor

__all__ = ["Checkpointer", "save_pytree", "load_pytree"]

_SEP = "/"


def _children(node):
    """(kind, [(key, child)]) of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    if hasattr(node, "tree_flatten"):
        children, _ = node.tree_flatten()
        return [(str(i), x) for i, x in enumerate(children)]
    return None


def _flatten_with_names(tree, prefix=()) -> dict:
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, child in kids:
        out.update(_flatten_with_names(child, prefix + (k,)))
    return out


def _rebuild(template, leaf_fn, prefix=()):
    """``template``'s structure with each leaf replaced by
    ``leaf_fn(name, leaf)``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaf_fn, prefix + (str(i),))
                              for i, v in enumerate(template))
    if hasattr(template, "tree_flatten"):
        children, aux = template.tree_flatten()
        return type(template).tree_unflatten(aux, [
            _rebuild(c, leaf_fn, prefix + (str(i),))
            for i, c in enumerate(children)])
    return leaf_fn(_SEP.join(prefix), template)


def _to_host(x) -> np.ndarray:
    """A leaf copied to a numpy array on the host (a copy for a CPU tensor
    too: the train step updates the state in place); a bf16 tensor as its
    uint16 bits."""
    if is_dtensor(x):
        x = x.detach().full_tensor()         # a collective: every rank
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The tensor a stored array holds, by the manifest's dtype."""
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _host_tree(flat: dict):
    """{name: (numpy array, dtype name)} — the flattened tree copied to the
    host (DTensor leaves gathered whole, one at a time). On a rank that
    does not write a tree of DTensors each leaf only joins its gather,
    nothing reaches the host, and the result is ``None``."""
    if not _writes(flat):
        for v in flat.values():
            if is_dtensor(v):
                v.detach().full_tensor()     # a collective: every rank
        return None
    return {k: (_to_host(v), _dtype_name(v)) for k, v in flat.items()}


def _distributed(flat: dict) -> bool:
    return any(is_dtensor(v) for v in flat.values())


def _writes(flat: dict) -> bool:
    """Whether this process writes the flattened tree ``flat``: always
    for plain tensors; for DTensors, rank 0 of the default group."""
    if not _distributed(flat):
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _barrier():
    import torch.distributed as dist
    dist.barrier()


def save_pytree(tree, directory: Path, *, shard_size_mb: int = 512):
    """Write a tree of tensors as npz shards + manifest into
    ``directory``. A tree of DTensors: every rank calls it, rank 0 writes,
    and all return once the files are there."""
    flat = _flatten_with_names(tree)
    host = _host_tree(flat)
    if host is not None:
        _write_host(host, Path(directory), shard_size_mb)
    if _distributed(flat):
        _barrier()


def _write_host(host: dict, directory: Path, shard_size_mb: int = 512):
    directory.mkdir(parents=True, exist_ok=True)
    shards: list[dict] = []
    cur: dict[str, np.ndarray] = {}
    cur_bytes = 0
    limit = shard_size_mb * 1024 * 1024

    def flush():
        nonlocal cur, cur_bytes
        if not cur:
            return
        fname = f"shard_{len(shards):05d}.npz"
        np.savez(directory / fname, **cur)
        shards.append({"file": fname, "keys": sorted(cur),
                       "sha256": _sha256(directory / fname)})
        cur, cur_bytes = {}, 0

    for k in sorted(host):
        arr = host[k][0]
        cur[k] = arr
        cur_bytes += arr.nbytes
        if cur_bytes >= limit:
            flush()
    flush()
    manifest = {
        "format": 1,
        "time": time.time(),
        "treedef": "repro_torch: " + ", ".join(sorted(host)),
        "keys": {k: {"shape": list(arr.shape), "dtype": dt}
                 for k, (arr, dt) in host.items()},
        "shards": shards,
    }
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=2))


def load_pytree(template, directory: Path, *, shardings=None):
    """Restore tensors into the structure of ``template``.

    Each leaf of ``template`` gives the dtype (a restore casts, e.g. fp32
    masters into bf16 weights) and the device of the tensor restored in its
    place; a leaf may be a ``torch.empty(..., device="meta")`` to restore
    onto the CPU without allocating the template.

    ``shardings``: optional matching tree of ``parallel.sharding``
    ``NamedSharding``s for elastic restore onto a (possibly different)
    mesh: each leaf is read whole by every rank and placed on its
    sharding's DTensor placements (each rank keeps its shard; no
    collective). A leaf whose sharding is None restores as without.
    """
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    data: dict[str, np.ndarray] = {}
    for sh in manifest["shards"]:
        f = directory / sh["file"]
        if _sha256(f) != sh["sha256"]:
            raise IOError(f"checkpoint shard corrupt: {f}")
        with np.load(f) as z:
            for k in sh["keys"]:
                data[k] = z[k]

    missing = set(_flatten_with_names(template)) - set(data)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    flat_sh = (_flatten_with_names(shardings) if shardings is not None
               else {})

    def leaf(name, like):
        t = _from_host(data[name], manifest["keys"][name]["dtype"])
        sh = flat_sh.get(name)
        if sh is not None:
            from repro_torch.parallel.sharding import place
            return place(t.to(device=sh.mesh.device_type, dtype=like.dtype),
                         sh)
        dev = "cpu" if like.device.type == "meta" else like.device
        return t.to(device=dev, dtype=like.dtype)

    return _rebuild(template, leaf)


class Checkpointer:
    """Directory layout: <root>/step_<N>/{manifest.json, shard_*.npz}"""

    def __init__(self, root, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # startup-only: clear tmp dirs left by a crashed previous process
        # (never during operation — a live async save owns its tmp dir)
        for d in self.root.glob("step_*.tmp-*"):
            shutil.rmtree(d, ignore_errors=True)

    # ---- discovery ----
    def steps(self) -> list[int]:
        out = []
        for d in self.root.iterdir():
            m = re.fullmatch(r"step_(\d+)", d.name)
            if m and (d / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ---- save ----
    def save(self, step: int, tree, *, blocking: bool = True):
        # Join any in-flight async save first — two concurrent writers
        # would race on retention/publish.
        self.wait()
        # Snapshot to host BEFORE returning (async safety: the train step
        # updates the state's tensors in place).
        flat = _flatten_with_names(tree)
        host = _host_tree(flat)
        distributed = _distributed(flat)
        if host is None:                     # a rank that does not write
            if blocking:
                _barrier()
            return
        if blocking:
            self._write(step, host)
            if distributed:
                _barrier()
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict):
        final = self.root / f"step_{step}"
        tmp = Path(tempfile.mkdtemp(prefix=f"step_{step}.tmp-",
                                    dir=self.root))
        try:
            _write_host(host, tmp)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic publish
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._prune()

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    # ---- restore ----
    def restore(self, step: Optional[int], template, *, shardings=None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, load_pytree(template, self.root / f"step_{step}",
                                 shardings=shardings)
