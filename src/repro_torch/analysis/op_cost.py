"""Per-rank cost of one call of a step function, counted op by op.

The port's counterpart of the reference's ``analysis/hlo_cost.py``, which
parses XLA's compiled HLO. Here there is no compiled program: the step is
run once, on meta tensors (DTensors on a fake process group for a mesh),
under ``OpCounter``, a ``TorchDispatchMode`` that sees every ATen op a
rank runs on its local shards (it returns ``NotImplemented`` for DTensor
arguments, so DTensor desugars the op into local ops and collectives
before the counter sees them, as ``MemTracker`` does):

  * FLOPs: ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` uses (``aten.mm`` / ``bmm`` / ``addmm`` /
    ``baddbmm`` / convolutions / SDPA, and ``repro_torch::dense_mm``, the
    op of every K1 product, whose formula ``kernels/ops.py`` registers), on
    the local shapes. On one rank the count equals ``FlopCounterMode``'s
    over the same step.
  * Bytes: each op that makes a tensor is charged the bytes of its tensor
    inputs and of its outputs; views, metadata queries and ``empty`` are
    free (the reference's ``_FREE_OPS``). That is the model of eager
    PyTorch, where every op is a kernel that reads and writes HBM. The
    reference models XLA's fusion instead (its
    ``test_elementwise_chain_fuses``): a chain of elementwise ops costs
    one read and one write there and one per op here.
  * Collectives: the functional collectives DTensor issues, by kind, each
    at ``roofline.wire_bytes`` of its result bytes and group size; the
    bytes of a group whose ranks span more than one 8-GPU node are also
    summed apart (``network_bytes``), for the slower link. Collectives
    issued through ``torch.distributed`` directly (the int8 moments'
    all-to-all) are charged as bytes only.
  * Peak live bytes: the largest sum over the call of the storages alive
    on the rank (the state and batch handed to ``track``, activations,
    gradients, optimizer temporaries), tracked by weak references.
  * ``fused_markers``: the ops inside a ``models.layers._scoped`` function
    of one of these names (``FUSED_ATTENTION_MARKERS``: the three attention
    cores) keep their FLOPs but are charged no bytes; the function's tensor
    arguments and results are charged once, as a fused kernel's reads and
    writes. PyTorch's autograd keeps no scope, so the backward of those
    ops is charged in full (the reference's name scopes follow its
    transposed ops).

Depth: every layer of a stack has the same shapes, so a step's counts are
linear in its depth. ``extrapolate`` takes counts at two depths (in whole
layer-pattern periods, see ``launch.dryrun.cut``) to the config's depth,
the counterpart of the reference's trip-count-aware accounting of a
scanned layer body.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.roofline import GPUS_PER_NODE, wire_bytes
from repro_torch.kernels.ops import DENSE_MM_OP
from repro_torch.models import layers

__all__ = ["OpCost", "OpCounter", "count", "extrapolate",
           "FUSED_ATTENTION_MARKERS"]

#: The ``_scoped`` name of the attention cores (``models/layers.py``),
#: whose intermediates a fused attention kernel keeps on chip.
FUSED_ATTENTION_MARKERS = ("flash_attention_core",)

#: Functional collectives (``torch.distributed._functional_collectives``,
#: and DTensor's own all-to-all: what DTensor issues on a mesh of the
#: card's device type) by op name -> roofline kind.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_FUNCTIONAL = ("_c10d_functional", "c10d_functional", "_dtensor")
#: Ops that make no tensor of their own: allocation, and the functional
#: collectives' bookkeeping.
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::new_empty", "aten::new_empty_strided",
         "_c10d_functional::wait_tensor",
         "_c10d_functional::_wrap_tensor_autograd",
         "c10d_functional::wait_tensor"}


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples / lists / dicts."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _frozen(x):
    """A hashable stand-in for an op argument; raises ``TypeError`` for
    one that has none, or for a tensor off the meta device."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError("not a meta tensor")
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_frozen(y) for y in x)
    hash(x)
    return (type(x), x)


def _signature(func, args, kwargs):
    """The memo key of a call (None when its arguments have none)."""
    try:
        return (func, _frozen(args), _frozen(tuple(sorted(kwargs.items()))))
    except TypeError:
        return None


def _spec_of(out):
    """Sizes, strides and dtypes of a call's meta outputs (None for a
    result that is not a meta tensor or a tuple of them)."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (tuple, list)) and out and all(
            isinstance(o, torch.Tensor) for o in out):
        specs = [_spec_of(o) for o in out]     # a list: several outputs
        return None if None in specs else specs
    return None


def _from_spec(spec):
    if isinstance(spec, list):
        return tuple(_from_spec(s) for s in spec)
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpCost:
    """Counts of one step on one rank. ``depths`` are the depths traced
    (one, or the two ``extrapolate`` took); ``depth`` the one the counts
    stand for."""
    flops: int
    bytes: int
    collectives: Dict[str, dict]
    peak_bytes: int
    dense_mm_calls: int
    depth: Optional[int] = None
    depths: Tuple[int, ...] = ()

    @property
    def collective_bytes(self) -> float:
        return sum(c["bytes"] for c in self.collectives.values())

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["collective_bytes"] = self.collective_bytes
        return out


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring). Use::

        with OpCounter() as c:
            c.track((state, batch))
            step(state, batch)
        cost = c.cost()
    """

    def __init__(self, *, fused_markers: tuple = ()):
        super().__init__()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor
        self.fused_markers = tuple(fused_markers)
        self.flops = 0
        self.bytes = 0
        self.dense_mm_calls = 0
        self.collectives: Dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self._infos: Dict[object, tuple] = {}
        self._memo: Dict[tuple, object] = {}
        self._groups: Dict[str, tuple] = {}
        self._fused_depth = 0
        self._fake_on_entry = None
        self._hook_before = None
        self._entered = 0

    # -- liveness -----------------------------------------------------------

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local shards) as live from now on."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            self._hold(t)
        self.peak = max(self.peak, self.live)

    def _hold(self, t) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n

    # -- the scope hook of models.layers._scoped ---------------------------

    def __enter__(self):
        if not self._entered:            # not the re-entry of decompose
            self._fake_on_entry = active_fake_mode()
            self._hook_before = layers._SCOPE_HOOK
            layers._SCOPE_HOOK = self._scope
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._entered -= 1
        if not self._entered:
            layers._SCOPE_HOOK = self._hook_before
        return super().__exit__(*exc)

    def _scope(self, name: str, fn, args, kwargs):
        if name not in self.fused_markers:
            return fn(*args, **kwargs)
        outer = self._fused_depth == 0
        if outer:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self._fused_depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._fused_depth -= 1
        if outer:
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out

    # -- ops ----------------------------------------------------------------

    def _group(self, name: str) -> tuple:
        """(size, whether the ranks span nodes) of a process group."""
        if name not in self._groups:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(name))
            nodes = {r // GPUS_PER_NODE for r in ranks}
            self._groups[name] = (len(ranks), len(nodes) > 1)
        return self._groups[name]

    def _collective(self, func, args, kwargs, out) -> None:
        kind = _COLLECTIVES.get(func._schema.name.split("::")[-1])
        if kind is None:
            return
        names = [a.name for a in func._schema.arguments]
        group = {**dict(zip(names, args)), **kwargs}["group_name"]
        g, spans = self._group(group)
        if g <= 1:
            return
        wire = wire_bytes(kind, sum(_nbytes(t) for t in _tensors(out)), g)
        slot = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0.0, "network_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += wire
        if spans:
            slot["network_bytes"] += wire

    def _info(self, func) -> tuple:
        """(decomposes, FLOP formula, collective, free, pure) of an op:
        whether ``FlopCounterMode`` would count it by its decomposition;
        its formula; whether it is a functional collective; whether it
        makes no tensor of its own (a view, ``empty``); and whether it is
        a pure function of its arguments' metadata on the meta device (no
        view, mutation or alias), whose output ``__torch_dispatch__`` may
        make from a memo."""
        info = self._infos.get(func)
        if info is None:
            schema = func._schema
            ns = schema.name.split("::")[0]
            dk = torch._C.DispatchKey.CompositeImplicitAutograd
            decomposes = func is not torch.ops.prim.device.default and (
                dk in func.py_kernels
                or torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), dk))
            aliased = schema.is_mutable or any(
                r.alias_info is not None for r in schema.returns)
            info = self._infos[func] = (
                decomposes, flop_registry.get(func._overloadpacket),
                ns in _FUNCTIONAL, func.is_view or schema.name in _FREE,
                not (func.is_view or aliased or ns in _FUNCTIONAL))
        return info

    def _run(self, func, args, kwargs, pure: bool):
        """``func(*args, **kwargs)``. A pure op on meta tensors runs once
        per signature (op, the tensors' shapes, strides and dtypes, the
        other arguments): later calls get new meta tensors of the memoized
        sizes, strides and dtypes. A long prefill calls the chunk scan's
        ops thousands of times with the same signature, and the meta
        kernels (Python references) are most of the time a dry run
        takes."""
        key = _signature(func, args, kwargs) if pure else None
        if key is None:
            return func(*args, **kwargs)
        spec = self._memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            self._memo[key] = _spec_of(out)
            return out
        return _from_spec(spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented        # DTensor runs it as local ops
        if active_fake_mode() is not self._fake_on_entry:
            return func(*args, **kwargs)  # DTensor's shape propagation
        decomposes, formula, collective, free, pure = self._info(func)
        # as FlopCounterMode: an op with a decomposition is counted by its
        # parts
        if decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = self._run(func, args, kwargs, pure)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if func is DENSE_MM_OP:
            self.dense_mm_calls += 1
        if collective:
            self._collective(func, args, kwargs, out)
        made = [] if free else _tensors(out)
        if made and not self._fused_depth:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in made)
        for t in made:
            self._hold(t)
        self.peak = max(self.peak, self.live)
        return out

    def cost(self, depth: Optional[int] = None) -> OpCost:
        return OpCost(flops=self.flops, bytes=self.bytes,
                      collectives={k: dict(v)
                                   for k, v in self.collectives.items()},
                      peak_bytes=self.peak,
                      dense_mm_calls=self.dense_mm_calls, depth=depth,
                      depths=() if depth is None else (depth,))


def count(fn, *args, fused_markers: tuple = (),
          depth: Optional[int] = None) -> OpCost:
    """The cost of ``fn(*args)`` on this rank, ``args`` live throughout.
    The result is dropped when the call returns."""
    with OpCounter(fused_markers=fused_markers) as c:
        c.track(args)
        fn(*args)
    return c.cost(depth)


def extrapolate(lo: OpCost, hi: OpCost, depth: int) -> OpCost:
    """The cost at ``depth`` from the costs at two depths, each count
    linear in depth (an integer count stays an integer where the line
    meets one)."""
    (d1,), (d2,) = lo.depths, hi.depths

    def lin(a, b):
        step = (b - a) * (depth - d1)
        if isinstance(step, int) and step % (d2 - d1) == 0:
            return a + step // (d2 - d1)
        return a + step / (d2 - d1)

    kinds = set(lo.collectives) | set(hi.collectives)
    zero = {"count": 0, "bytes": 0.0, "network_bytes": 0.0}
    colls = {k: {f: lin(lo.collectives.get(k, zero)[f],
                        hi.collectives.get(k, zero)[f]) for f in zero}
             for k in sorted(kinds)}
    return OpCost(flops=lin(lo.flops, hi.flops),
                  bytes=lin(lo.bytes, hi.bytes), collectives=colls,
                  peak_bytes=lin(lo.peak_bytes, hi.peak_bytes),
                  dense_mm_calls=lin(lo.dense_mm_calls, hi.dense_mm_calls),
                  depth=depth, depths=(d1, d2))
