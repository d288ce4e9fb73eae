"""Parameter / state / batch / cache placement rules on a device mesh.

The port of the reference's ``parallel/sharding.py``. The rules are the
reference's, entry for entry:

  * ``mode="train"``  — FSDP(+TP): every weight 2-D sharded (one dim over
    "data" for ZeRO-style memory scaling, one over "model" for Megatron TP).
  * ``mode="decode"`` — pure TP: weights sharded over "model" only
    (replicated across "data"/"pod"), so a decoded token gathers no
    parameter.

A rule axis that does not divide its tensor dim is dropped to replication
for that dim (it never pads): that is how kv_heads=8, vocab=51865,
n_experts=8 etc. degrade on a 16-wide axis.

A spec is a ``PartitionSpec``: one entry per tensor dim, each ``None``, a
mesh-axis name or a tuple of names (major first), as the reference's
``jax.sharding.PartitionSpec``. ``named(mesh, spec_tree)`` turns each spec
into a ``NamedSharding``: the mesh and the DTensor placements that stand
for the spec on a ``torch.distributed`` ``DeviceMesh`` (``Shard(d)`` on
every mesh dim the entry of tensor dim ``d`` names, ``Replicate`` on the
others). A mesh axis can shard one tensor dim only: where a spec names it
twice (an MoE expert weight whose expert and model dims both take "data"),
the first dim keeps it and the later one replicates.

The rules need no devices: ``mesh`` is a ``DeviceMesh`` or a plain
``{axis name: size}`` mapping. Trees are the port's nested dicts (with
``train.optimizer.QTensor`` moment leaves); a path is the tuple of dict
keys down to a leaf.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch

__all__ = ["PartitionSpec", "P", "NamedSharding", "param_specs",
           "state_specs", "batch_specs", "cache_partition_specs", "named",
           "spec_tree_to_shardings", "mesh_shape", "place", "to_flat_rows",
           "from_flat_rows"]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: each entry ``None``, an axis name or a
    tuple of axis names. As in ``jax.sharding.PartitionSpec`` a tuple of
    one name is that name, so ``tuple(spec)`` compares entry by entry with
    the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# Stacked-layer containers -> number of leading scan dims to skip.
_STACK_DIMS = {"blocks": 1, "enc_blocks": 1, "tail_blocks": 1, "m_blocks": 2}

# (dim -> logical role) per parameter name; roles resolved per mode below.
# Roles: "fsdp" (shard over data in train), "tp" (shard over model),
#        None (replicate).
_PARAM_RULES = {
    # embeddings: vocab-parallel (Megatron)
    "embed": ("tp", "fsdp"),
    "lm_head": ("tp", "fsdp"),
    # attention
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp_kv"),
    "wv": ("fsdp", "tp_kv"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp_kv",), "bv": ("tp_kv",),
    # mlp
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # moe (leading expert dim)
    "router": ("fsdp", None),
    # ssm
    "w_in": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "norm_w": (None,),
}
# MoE expert tensors get an expert-dim role prepended at lookup time.
_MOE_3D = {"w_gate": ("ep", "fsdp", "tp"), "w_up": ("ep", "fsdp", "tp"),
           "w_down": ("ep", "tp", "fsdp")}


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of such a mapping)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _dict_keys(path) -> list:
    return [k for k in path if isinstance(k, str)]


def _leaf_name(path) -> str:
    keys = _dict_keys(path)
    return keys[-1] if keys else ""


def _stack_depth(path) -> int:
    return sum(_STACK_DIMS.get(k, 0) for k in _dict_keys(path))


def _in_moe(path) -> bool:
    return "moe" in _dict_keys(path)


def _resolve_role(role: Optional[str], mode: str, cfg):
    """role -> mesh axis name or None."""
    if role is None:
        return None
    if role == "fsdp":
        return "data" if mode == "train" else None
    if role in ("tp", "tp_kv"):
        # tp_kv: the kv projections' out-dim over model only when whole kv
        # heads divide the axis (the head guard in _spec_for_leaf)
        return "model"
    if role == "ep":
        return "data" if mode == "train" else None
    raise ValueError(role)


def _axis_size(sizes: dict, axes) -> int:
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def _spec_for_leaf(path, leaf, cfg, sizes: dict, mode: str):
    name = _leaf_name(path)
    nstack = _stack_depth(path)
    shape = tuple(leaf.shape)[nstack:]

    if _in_moe(path) and name in _MOE_3D:
        roles = _MOE_3D[name]
    elif name in _PARAM_RULES:
        roles = _PARAM_RULES[name]
    else:
        roles = (None,) * len(shape)

    entries = []
    for dim in range(len(shape)):
        role = roles[dim] if dim < len(roles) else None
        axes = _resolve_role(role, mode, cfg)
        if axes is None:
            entries.append(None)
            continue
        # head-alignment guard for kv projections
        if role == "tp_kv" and cfg is not None and \
                cfg.n_kv_heads % _axis_size(sizes, axes):
            entries.append(None)
            continue
        if shape[dim] % _axis_size(sizes, axes):
            entries.append(None)       # divisibility fallback -> replicate
            continue
        entries.append(axes)
    return P(*((None,) * nstack + tuple(entries)))


def _is_qtensor(x) -> bool:
    return hasattr(x, "tree_flatten") and hasattr(x, "scale")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts; a ``QTensor`` maps its ``q``
    and ``scale`` (path keys 0 and 1) into a ``QTensor`` of the results."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_qtensor(tree):
        return dataclasses.replace(tree, q=fn(path + (0,), tree.q),
                                   scale=fn(path + (1,), tree.scale))
    return fn(path, tree)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of same-structured trees (QTensors opened)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_qtensor(tree):
        return dataclasses.replace(
            tree, q=fn(tree.q, *(r.q for r in rest)),
            scale=fn(tree.scale, *(r.scale for r in rest)))
    return fn(tree, *rest)


def param_specs(params, cfg, mesh, mode: str = "train"):
    """PartitionSpec tree matching ``params`` (same structure)."""
    sizes = mesh_shape(mesh)
    return _map_with_path(
        lambda path, leaf: _spec_for_leaf(path, leaf, cfg, sizes, mode),
        params)


def state_specs(state_shapes, cfg, mesh, mode: str = "train"):
    """Specs for a full train state {params, opt:{m, v, step}}.

    Optimizer moments inherit the parameter rules (same shapes) except when
    stored as int8 QTensors, whose (n_blocks, block)/(n_blocks,) leaves are
    sharded over "data" when divisible.
    """
    sizes = mesh_shape(mesh)
    p_spec = param_specs(state_shapes["params"], cfg, sizes, mode)
    dsize = sizes["data"]
    int8 = cfg.optimizer_state_dtype == "int8"

    def moment_spec(path, leaf):
        ndim = len(leaf.shape)
        if int8 and ndim >= 1 and leaf.shape[0] % dsize == 0:
            return P(*(("data",) + (None,) * (ndim - 1)))
        if int8:
            return P(*((None,) * ndim))
        return _spec_for_leaf(path, leaf, cfg, sizes, mode)

    opt = state_shapes["opt"]
    return {"params": p_spec,
            "opt": {"m": _map_with_path(moment_spec, opt["m"]),
                    "v": _map_with_path(moment_spec, opt["v"]),
                    "step": P()}}


def _dp(sizes: dict) -> tuple:
    return ("pod", "data") if "pod" in sizes else ("data",)


def batch_specs(mesh, kind: str):
    """Specs for the step inputs (tokens/targets/frames/vision_embeds)."""
    dp = _dp(mesh_shape(mesh))
    tok = P(dp, None)
    return {"tokens": tok, "targets": tok,
            "frames": P(dp, None, None),
            "vision_embeds": P(dp, None, None)}


def cache_partition_specs(cache_tree, cfg, mesh):
    """Decode-cache specs: batch over dp; heads over model when divisible."""
    sizes = mesh_shape(mesh)
    dp = _dp(sizes)
    dp_n = _axis_size(sizes, dp)
    tp_n = sizes["model"]

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if name == "pos":
            return P(dp if shape[0] % dp_n == 0 else None)
        if name in ("k", "v", "enc_k", "enc_v"):
            # (L, B, C, Hkv, Dh). The "model" axis goes to: 1. kv heads
            # when divisible; 2. the context dim C (split-KV decode);
            # 3. head_dim Dh.
            bspec = dp if shape[1] % dp_n == 0 else None
            if cfg.n_kv_heads % tp_n == 0:
                return P(None, bspec, None, "model", None)
            if shape[2] % tp_n == 0:
                return P(None, bspec, "model", None, None)
            if shape[4] % tp_n == 0:
                return P(None, bspec, None, None, "model")
            return P(None, bspec, None, None, None)
        if name == "ssm_state":
            # (L, B, H, P, N)
            b_ok = shape[1] % dp_n == 0
            h_ok = shape[2] % tp_n == 0
            p_ok = shape[3] % tp_n == 0
            return P(None, dp if b_ok else None,
                     "model" if h_ok else None,
                     "model" if (p_ok and not h_ok) else None, None)
        if name == "conv_state":
            # (L, B, W-1, conv_dim)
            b_ok = shape[1] % dp_n == 0
            c_ok = shape[3] % tp_n == 0
            return P(None, dp if b_ok else None, None,
                     "model" if c_ok else None)
        return P(*((None,) * len(shape)))

    return _map_with_path(spec, cache_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``; ``placements`` are its DTensor
    placements, one per mesh dim."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh, spec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry ``d`` names, ``Replicate`` elsewhere. A mesh dim
    named by two entries shards the first."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            if out[i] == Replicate():
                out[i] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree):
    """PartitionSpec tree -> NamedSharding tree."""
    return _map(lambda s: NamedSharding(mesh, s), spec_tree)


def spec_tree_to_shardings(mesh, tree):
    return named(mesh, tree)


def place(tree, shardings):
    """DTensors of a tree of full tensors that every rank holds alike:
    each rank keeps its own shard of each leaf, placed as ``shardings``
    says (``NamedSharding`` leaves, or ``None`` to leave a leaf as it is).
    No collective runs. A shard smaller than its leaf is a copy, so the
    full tensor can be freed; a leaf the mesh does not split is kept as it
    is (no copy on a 1x1 mesh)."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(x, sh):
        if sh is None:
            return x
        full = DTensor.from_local(x, sh.mesh,
                                  [Replicate()] * sh.mesh.ndim,
                                  run_check=False)
        out = full.redistribute(sh.mesh, sh.placements)
        local = out.to_local()
        if local.numel() == x.numel():
            return out
        return DTensor.from_local(local.clone(), sh.mesh, sh.placements,
                                  run_check=False, shape=out.shape,
                                  stride=out.stride())
    return _map(one, tree, shardings)


# ---------------------------------------------------------------------------
# A DTensor's values in a flat row layout (the int8 moments' blocks), and
# back, by one all-to-all: no rank holds more than its own rows
# ---------------------------------------------------------------------------

def _shard_steps(shape, mesh, placements) -> list:
    """[(mesh dim, tensor dim, shard length)] of ``placements`` in mesh-dim
    order: nested shards of one tensor dim split it in that order, as
    DTensor does. Shards must be even; ``Partial`` is refused."""
    from torch.distributed.tensor import Replicate, Shard
    sizes, out = list(shape), []
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if sizes[pl.dim] % n:
                raise ValueError(f"{tuple(shape)} under {placements}: "
                                 f"uneven shards are not supported")
            sizes[pl.dim] //= n
            out.append((i, pl.dim, sizes[pl.dim]))
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} is not supported")
    return out


class _Layout:
    """Which rank holds which elements of a tensor flattened row-major:
    ``box`` for a DTensor's own placements, ``rows`` for a ``(R, block)``
    DTensor of its flat values (row ``r`` holds elements ``[r * block,
    (r + 1) * block)``, zeros past the end), sharded over dim 0 or
    replicated."""

    def __init__(self, t, *, rows_of=None):
        self.mesh = t.device_mesh
        self.device = t.to_local().device
        self.steps = _shard_steps(tuple(t.shape), self.mesh, t.placements)
        self.shard_dims = {i for i, _, _ in self.steps}
        if rows_of is None:
            self.shape, self.n, self.block = tuple(t.shape), t.numel(), None
        else:
            if any(d != 0 for _, d, _ in self.steps):
                raise ValueError("rows are sharded over dim 0 only")
            self.shape, self.n, self.block = (rows_of,), rows_of, t.shape[1]
            self.rows = t.shape[0]

    def _first(self, c) -> list:
        """The first index on each dim (rows: the first row) at ``c``."""
        lo = [0] * (1 if self.block else len(self.shape))
        for i, d, ln in self.steps:
            lo[d] += c[i] * ln
        return lo

    def held(self, c):
        """The flat indices held at mesh coordinate ``c``, rising (a box's
        in its row-major order), and their positions in the local flat
        tensor."""
        lo = self._first(c)
        if self.block:
            ln = self.steps[-1][2] if self.steps else self.rows
            a = min(lo[0] * self.block, self.n)
            b = min((lo[0] + ln) * self.block, self.n)
            p = torch.arange(a, b, device=self.device)
            return p, p - lo[0] * self.block
        size = list(self.shape)
        for _, d, ln in self.steps:
            size[d] = ln
        p = torch.zeros((), dtype=torch.int64, device=self.device)
        for d, st in enumerate(_strides(self.shape)):
            p = p.unsqueeze(-1) + torch.arange(
                lo[d], lo[d] + size[d], device=self.device) * st
        p = p.reshape(-1)
        return p, torch.arange(p.numel(), device=self.device)

    def coords(self, p) -> dict:
        """{mesh dim: the coordinate on it of the rank holding each of
        the flat indices ``p``}, for the mesh dims this layout shards."""
        out, rem = {}, {}
        for i, d, ln in self.steps:
            if d not in rem:
                rem[d] = (p // self.block if self.block
                          else (p // _strides(self.shape)[d])
                          % self.shape[d])
            out[i] = rem[d] // ln
            rem[d] = rem[d] % ln
        return out


def _strides(shape) -> list:
    return [math.prod(shape[d + 1:]) for d in range(len(shape))]


def _exchange(values, src: _Layout, dst: _Layout, out):
    """One all-to-all over the default group: ``out`` (this rank's local
    flat tensor in ``dst``) receives the elements it holds from
    ``values`` (the local flat tensor in ``src``). Each element comes from
    the one rank that holds it in ``src`` and shares the receiver's
    coordinates on the mesh dims ``src`` replicates; every rank calls
    it."""
    import torch.distributed as dist
    mesh, world = src.mesh, dist.get_world_size()
    if mesh.size() != world:
        raise ValueError("the mesh must span every rank of the default "
                         "group")
    ranks = mesh.mesh.to(src.device)
    me = mesh.get_coordinate()
    rep = set(range(mesh.ndim)) - src.shard_dims

    def rank_of(coords):
        return ranks[tuple(coords[i] for i in range(mesh.ndim))]

    # what this rank sends: each element it holds to every rank that holds
    # it in dst and takes it from here
    p, pos = src.held(me)
    c = dst.coords(p)
    keep = torch.ones_like(p, dtype=torch.bool)
    for i in rep & dst.shard_dims:
        keep &= c[i] == me[i]
    p, pos = p[keep], pos[keep]
    fixed = {i: c[i][keep] for i in dst.shard_dims}
    fixed.update({i: torch.full_like(p, me[i])
                  for i in rep - dst.shard_dims})
    fan = [i for i in range(mesh.ndim) if i not in fixed]
    to, send = [], []
    for combo in itertools.product(*(range(mesh.size(i)) for i in fan)):
        coords = {**fixed, **{i: torch.full_like(p, v)
                              for i, v in zip(fan, combo)}}
        to.append(rank_of(coords))
        send.append(pos)
    to, send = torch.cat(to), torch.cat(send)
    order = torch.argsort(to, stable=True)
    send_splits = torch.bincount(to, minlength=world).tolist()

    # what it receives: each element it holds in dst, from its sender
    q, qpos = dst.held(me)
    c = src.coords(q)
    c.update({i: torch.full_like(q, me[i]) for i in rep})
    frm = rank_of(c)
    recv_order = torch.argsort(frm, stable=True)
    recv = values.new_empty(q.numel())
    dist.all_to_all_single(recv, values[send[order]].contiguous(),
                           torch.bincount(frm, minlength=world).tolist(),
                           send_splits)
    out[qpos[recv_order]] = recv
    return out


def to_flat_rows(x, rows_like):
    """This rank's rows of ``rows_like``'s layout filled with ``x``'s
    values: a local ``(r, block)`` tensor (``r`` its local rows), the
    elements of ``x`` flattened row-major at ``[row * block, ...)``, zeros
    past ``x``'s end. One all-to-all: no rank holds more than its own
    part of either layout. Every rank calls it."""
    from torch.distributed.tensor import Replicate
    x = x.redistribute(x.device_mesh, [Replicate() if pl.is_partial()
                                       else pl for pl in x.placements])
    local = x.to_local().reshape(-1)
    rows = rows_like.to_local().shape[0]
    out = torch.zeros(rows * rows_like.shape[1], dtype=local.dtype,
                      device=local.device)
    return _exchange(local, _Layout(x), _Layout(rows_like, rows_of=x.numel()),
                     out).reshape(rows, -1)


def from_flat_rows(rows, rows_like, like):
    """The inverse of ``to_flat_rows``: a DTensor with ``like``'s mesh,
    placements and shape whose values are those that this rank's local
    ``rows`` (and every other rank's) hold in ``rows_like``'s layout."""
    from torch.distributed.tensor import DTensor
    local_shape = like.to_local().shape
    out = _exchange(rows.reshape(-1),
                    _Layout(rows_like, rows_of=like.numel()), _Layout(like),
                    rows.new_empty(local_shape.numel()))
    return DTensor.from_local(out.reshape(local_shape), like.device_mesh,
                              like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())
