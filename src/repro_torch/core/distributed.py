"""Mesh-sharded matrix exponentiation — the paper's algorithm across devices.

The port of the reference's ``repro/core/distributed.py``. Each squaring of
the chain is ONE collective matmul over a 2-D device mesh, so A^p costs
ceil(log2 p) collective matmuls with A resident and 2-D sharded the whole
time.

PyTorch's idiom stands for JAX's:

  * a ``torch.distributed.device_mesh.DeviceMesh`` with named dims for
    ``jax.sharding.Mesh``;
  * a ``DTensor`` placed ``Shard(0)`` on the ``row_axis`` dim and
    ``Shard(1)`` on the ``col_axis`` dim for ``NamedSharding(mesh,
    P(row_axis, col_axis))``;
  * SPMD calls: every rank of the mesh calls every function here with the
    same arguments in the same order, as every rank runs its own Python
    (the reference traces one program for all devices). A plain tensor
    argument is the full matrix, the same on every rank;
  * collectives on the mesh's dim groups (``mesh.get_group(col_axis)`` for
    a row panel, ``mesh.get_group(row_axis)`` for a column panel) and
    point-to-point exchanges (``dist.batch_isend_irecv``) between global
    ranks. The same code runs on ``gloo`` (CPU meshes) and ``nccl`` (the
    card), on the current stream.

Two collective-matmul schedules over a (rows x cols) mesh:

  * ``matmul_2d_gather`` — all-gather A's block along the col group and
    B's along the row group, one local product. Any mesh shape.
  * ``matmul_cannon``    — Cannon's algorithm on square meshes: the skew is
    ONE point-to-point exchange (each rank knows its coordinates on the
    host; the reference's log2 rounds of masked ``ppermute`` exist because
    its axis index is traced), then ``rows`` steps of a local product added
    into the accumulator, with a ring shift between steps.

Every local product is ``kernels.ops.matmul`` — K1 on a CUDA block (the
f32 FMA kernel, the bf16/f16 tensor-core kernel, the fp64 DMMA kernel),
its plain version on a CPU block. The accumulator is fp32 for
f32/bf16/f16 and **f64 for f64** (the reference accumulates f64 operands in
fp32, ``distributed.py:70,129``, so its f64 chains are only f32-accurate);
a product is cast to the operand's dtype once, at its end. A shift whose
peer is the rank itself is a local copy, never a send, so a 1x1 mesh runs
no collective at all.

``ShardedMatmulChain`` gives the mesh path the pad-once / unpad-once
contract of :class:`~repro_torch.kernels.ops.PaddedChain`;
``matpow_sharded`` and ``expm_sharded`` route through it.

``torch.distributed.tensor`` is imported inside the functions that use it:
importing it costs more than a second, and every user of
``repro_torch.core`` would pay it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import accum_dtype, exact_matmul_settings
from repro_torch.kernels import ops as _kops
from repro_torch.kernels.ops import PaddedChain

__all__ = [
    "matmul_2d_gather",
    "matmul_cannon",
    "sharded_matmul",
    "ShardedMatmulChain",
    "matpow_sharded",
    "expm_sharded",
]


class _Layout:
    """Where this rank sits on a mesh's (row_axis, col_axis) dims: the
    dims' indices and sizes, this rank's coordinates, and the DTensor
    placements of ``P(row_axis, col_axis)``."""

    def __init__(self, mesh, row_axis: str, col_axis: str):
        from torch.distributed.tensor import Replicate, Shard
        names = mesh.mesh_dim_names or ()
        if row_axis not in names or col_axis not in names \
                or row_axis == col_axis:
            raise ValueError(f"mesh dims {names} must name row_axis "
                             f"{row_axis!r} and col_axis {col_axis!r}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        self.mesh = mesh
        self.row_axis, self.col_axis = row_axis, col_axis
        self.rdim, self.cdim = names.index(row_axis), names.index(col_axis)
        self.rows, self.cols = mesh.size(self.rdim), mesh.size(self.cdim)
        self.coord = list(coord)
        self.i, self.j = coord[self.rdim], coord[self.cdim]
        placements = [Replicate()] * mesh.ndim
        placements[self.rdim], placements[self.cdim] = Shard(0), Shard(1)
        self.placements = tuple(placements)

    def rank_at(self, i: int, j: int) -> int:
        """Global rank at (row i, col j), this rank's other coordinates."""
        coord = list(self.coord)
        coord[self.rdim], coord[self.cdim] = i % self.rows, j % self.cols
        return int(self.mesh.mesh[tuple(coord)])

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full (m, n) matrix, in ``torch.chunk``'s
        layout (what a ``Shard`` placement means): a view, no copy."""
        def span(size, parts, k):
            step = -(-size // parts)
            lo = min(k * step, size)
            return slice(lo, min(lo + step, size))
        return full[span(full.shape[0], self.rows, self.i),
                    span(full.shape[1], self.cols, self.j)]

    def wrap(self, local: torch.Tensor, shape) -> "DTensor":  # noqa: F821
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=(shape[1], 1))

    def local(self, x, what: str) -> torch.Tensor:
        """The local block of ``x`` placed ``P(row_axis, col_axis)``: a
        DTensor is redistributed there if placed otherwise; a plain tensor
        is the full matrix (SPMD) and this rank takes its block. Shards must
        be even (the schedules exchange equal blocks)."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            if tuple(x.placements) != self.placements:
                x = x.redistribute(self.mesh, self.placements)
            blk = x.to_local()
        else:
            _check_device(x, self.mesh)
            blk = self.block(x)
        m, n = x.shape
        if m % self.rows or n % self.cols:
            raise ValueError(
                f"{what}: a ({m}, {n}) operand does not shard evenly over a "
                f"{self.rows}x{self.cols} mesh; ShardedMatmulChain pads once "
                f"at the chain boundary")
        return blk.contiguous()


def _check_device(x: torch.Tensor, mesh) -> None:
    if x.device.type != mesh.device_type:
        raise ValueError(f"a tensor on {x.device} cannot enter a mesh over "
                         f"{mesh.device_type!r} (nothing is moved quietly)")


def _local_product(a: torch.Tensor, b: torch.Tensor, out_dtype, out=None):
    """a @ b through ``ops.matmul`` (K1 on a CUDA block, its plain version
    on a CPU block): accumulated in ``accum_dtype(a.dtype)``, rounded once
    to ``out_dtype``, written into ``out`` when given. Contiguous, as the
    collectives need: where ``ops.matmul`` padded to K1's tiles (blocks of
    a bare schedule's operands) it returns a strided view."""
    return _kops.matmul(a, b, out_dtype=out_dtype, out=out).contiguous()


def _gather_local(a_blk, b_blk, lay: _Layout, out=None) -> torch.Tensor:
    def gather(blk, axis, dim):
        group = lay.mesh.get_group(axis)
        if dist.get_world_size(group) == 1:
            return blk
        parts = [torch.empty_like(blk)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, blk, group=group)
        return torch.cat(parts, dim=dim)

    a_row = gather(a_blk, lay.col_axis, 1)       # (m/r, k): the row panel
    b_col = gather(b_blk, lay.row_axis, 0)       # (k, n/c): the col panel
    return _local_product(a_row, b_col, a_blk.dtype, out)


def _exchange(pairs) -> list:
    """Send each ``(tensor, to, from)`` block to global rank ``to`` and
    receive its replacement from ``from``, all in one batch; a block whose
    peer is this rank stays (never a send to oneself)."""
    me = dist.get_rank()
    ops, out = [], []
    for tag, (blk, to, frm) in enumerate(pairs):
        if to == me:
            out.append(blk)
            continue
        buf = torch.empty_like(blk)
        ops += [dist.P2POp(dist.isend, blk, to, tag=tag),
                dist.P2POp(dist.irecv, buf, frm, tag=tag)]
        out.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _cannon_local(a_blk, b_blk, lay: _Layout, out=None) -> torch.Tensor:
    i, j, c = lay.i, lay.j, lay.cols
    dtype = a_blk.dtype
    acc_dtype = accum_dtype(dtype)
    # Skew: A(i, j) -> (i, j - i), B(i, j) -> (i - j, j).
    a_cur, b_cur = _exchange([
        (a_blk, lay.rank_at(i, j - i), lay.rank_at(i, j + i)),
        (b_blk, lay.rank_at(i - j, j), lay.rank_at(i + j, j))])
    # f32 / f64 accumulate in the result's own buffer; 16-bit in fp32.
    acc = None
    for step in range(c):
        if acc is None:
            acc = _local_product(a_cur, b_cur, acc_dtype,
                                 out if acc_dtype == dtype else None)
        else:
            acc.add_(_local_product(a_cur, b_cur, acc_dtype))
        if step + 1 < c:
            # Ring shift: A one column left, B one row up. (The reference
            # also shifts after the last step, which only carries the
            # blocks back to their skewed places.)
            a_cur, b_cur = _exchange([
                (a_cur, lay.rank_at(i, j - 1), lay.rank_at(i, j + 1)),
                (b_cur, lay.rank_at(i - 1, j), lay.rank_at(i + 1, j))])
    if acc.dtype == dtype:
        return acc
    return acc.to(dtype) if out is None else out.copy_(acc)


def _check_square_mesh(lay: _Layout) -> None:
    if lay.rows != lay.cols:
        raise ValueError(f"Cannon needs a square mesh, got "
                         f"{lay.rows}x{lay.cols}; use matmul_2d_gather "
                         f"instead")


def _sharded(local_fn, a, b, mesh, row_axis, col_axis, what):
    lay = _Layout(mesh, row_axis, col_axis)
    if a.shape[-1] != b.shape[0] or a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"{what}: bad shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    c = local_fn(lay.local(a, what), lay.local(b, what), lay)
    return lay.wrap(c, (a.shape[0], b.shape[1]))


def matmul_2d_gather(a, b, mesh, *, row_axis: str = "data",
                     col_axis: str = "model"):
    """C = A @ B with A, B, C all 2-D sharded ``P(row_axis, col_axis)``:
    all-gather A's block along the col group (the (m/r, k) row panel) and
    B's along the row group (the (k, n/c) column panel), then one local
    product. ``a`` / ``b``: DTensors (redistributed if placed otherwise) or
    the full matrices, the same on every rank. Returns a DTensor."""
    return _sharded(_gather_local, a, b, mesh, row_axis, col_axis,
                    "matmul_2d_gather")


def matmul_cannon(a, b, mesh, *, row_axis: str = "data",
                  col_axis: str = "model"):
    """Cannon's algorithm: square-mesh collective matmul with ring shifts.

    Requires ``mesh`` sizes of ``row_axis`` and ``col_axis`` to be equal and
    block-divisible operands. Per step the working set is one A block and
    one B block per rank; the skew is one point-to-point exchange, and the
    ``rows`` local products add into one accumulator (fp32, f64 for f64)
    cast once at the end. Operands as :func:`matmul_2d_gather`.
    """
    _check_square_mesh(_Layout(mesh, row_axis, col_axis))
    return _sharded(_cannon_local, a, b, mesh, row_axis, col_axis,
                    "matmul_cannon")


def _pick_algorithm(algorithm: str, rows: int, cols: int) -> str:
    """Resolve ``"auto"`` to a concrete schedule for an (rows x cols) mesh:
    Cannon on a square multi-device mesh, the all-gather schedule on every
    other shape (rectangular, 1 x c / r x 1, one device)."""
    if algorithm == "auto":
        return "cannon" if rows == cols and rows > 1 else "gather"
    if algorithm not in ("cannon", "gather"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return algorithm


_SCHEDULES = {"gather": matmul_2d_gather, "cannon": matmul_cannon}


def sharded_matmul(a, b, mesh, *, algorithm: str = "auto",
                   row_axis: str = "data", col_axis: str = "model"):
    """C = A @ B with A, B, C all 2-D sharded ``P(row_axis, col_axis)``.

    Dispatches to the schedule for this mesh shape (:func:`_pick_algorithm`:
    ``"cannon"`` on square multi-device meshes, ``"gather"`` otherwise);
    pass either name to force one. Operand dims must divide the mesh dims —
    :class:`ShardedMatmulChain` handles arbitrary sizes by padding once at
    the chain boundary. Returns a DTensor, accumulated in fp32 (f64 for f64)
    and cast once to the operands' dtype.
    """
    lay = _Layout(mesh, row_axis, col_axis)
    algorithm = _pick_algorithm(algorithm, lay.rows, lay.cols)
    return _SCHEDULES[algorithm](a, b, mesh, row_axis=row_axis,
                                 col_axis=col_axis)


def _shard_multiple(n: int, rows: int, cols: int, dtype, backend) -> int:
    """The multiple a chain's shards are padded to: the K1 tile that
    ``ops.pick_blocks`` gives for the local product at the padded size
    (``backend``: the mesh's device type), so that K1 never pads inside the
    chain. Raising the multiple can move the pick to a larger tile, so it
    is repeated until the tile divides the shards (at most the largest
    tile, 128)."""
    step, mult = math.lcm(rows, cols), 1
    while True:
        p = -(-n // (step * mult)) * step * mult
        tile = _kops.pick_blocks(p // rows, p // cols, p, dtype=dtype,
                                 backend=backend)[0]
        if (p // rows) % tile == 0 and (p // cols) % tile == 0:
            return mult
        mult = math.lcm(mult, tile)


class ShardedMatmulChain(PaddedChain):
    """Distributed analogue of ``ops.MatmulChain``: pad once, collective
    squarings on the resident 2-D-sharded operand, unpad once.

        chain = ShardedMatmulChain(a.shape[-1], a.dtype, mesh)
        x = chain.pad(a)           # ONE pad to mesh multiples + placement
        x = chain.square(x)        # k times: collective squarings
        ...
        out = chain.unpad(result)  # ONE slice back to (n, n)

    * ``pad`` zero-pads (n, n) up to ``padded_n`` — the smallest multiple
      of ``lcm(rows, cols) * shard_multiple`` >= n, so every shard is even
      — and places it ``P(row_axis, col_axis)``: each rank keeps its block
      of the full matrix it was given (no communication). It never hands
      the caller's tensor into the chain.
    * ``shard_multiple`` defaults to the K1 tile ``ops.pick_blocks`` gives
      for the local product (:func:`_shard_multiple`), so K1 never pads
      inside the chain — on a CPU mesh too, whose plain version takes the
      same tiles, so the CPU runs the card's padding. (The reference's 128
      was the TPU's MXU width, and 1 off the TPU.)
    * ``square`` CONSUMES its argument when the chain donates: the chain
      keeps two local buffers and ping-pongs, the squaring after next
      writing its result into the consumed operand's block. ``mm`` never
      writes an operand; ``donate=False`` never writes one either.
    * ``unpad`` returns a DTensor of global shape (n, n) in ``Shard``'s
      layout: the padded blocks are sliced in place where the padded shard
      equals ``ceil(n / k)``, else the matrix is gathered and sliced.
    * ``algorithm="auto"`` resolves per mesh shape at construction, so every
      step of one chain runs the same schedule.
    """

    def __init__(self, n: int, dtype, mesh, *, algorithm: str = "auto",
                 row_axis: str = "data", col_axis: str = "model",
                 shard_multiple: Optional[int] = None, donate: bool = True):
        super().__init__(n, dtype, donate=donate)
        self.mesh = mesh
        self.row_axis, self.col_axis = row_axis, col_axis
        self.layout = _Layout(mesh, row_axis, col_axis)
        rows, cols = self.layout.rows, self.layout.cols
        self.algorithm = _pick_algorithm(algorithm, rows, cols)
        if shard_multiple is None:
            shard_multiple = _shard_multiple(self.n, rows, cols, dtype,
                                             mesh.device_type)
        step = math.lcm(rows, cols) * int(shard_multiple)
        self.padded_n = (self.n + step - 1) // step * step
        if self.algorithm == "cannon":
            _check_square_mesh(self.layout)
        self._local_fn = (_cannon_local if self.algorithm == "cannon"
                          else _gather_local)
        self._spare = None

    def _wrap(self, local: torch.Tensor, size: int):
        return self.layout.wrap(local, (size, size))

    # -- chain boundary ----------------------------------------------------
    def pad(self, a):
        """Pad (n, n) -> (P, P) and place it. ONCE.

        ``a`` is the full matrix, the same on every rank, or a DTensor
        (gathered first). One ``ops.pad_to_blocks`` call where P != n; each
        rank then copies out its block (at P == n with ``donate=False`` a
        contiguous block may be a view of ``a``, which the chain never
        writes)."""
        from torch.distributed.tensor import DTensor
        if isinstance(a, DTensor):
            a = a.full_tensor()
        if a.ndim != 2 or tuple(a.shape) != (self.n, self.n):
            raise ValueError(f"sharded chains take one ({self.n}, "
                             f"{self.n}) matrix, got shape "
                             f"{tuple(a.shape)}")
        _check_device(a, self.mesh)
        if self.padded_n != self.n:
            # Through the module attribute, so a count of the chain's pads
            # sees this call.
            a = _kops.pad_to_blocks(a, self.padded_n, self.padded_n)
            blk = self.layout.block(a).contiguous()
        elif self.donate:
            blk = self.layout.block(a).clone(
                memory_format=torch.contiguous_format)
        else:
            blk = self.layout.block(a).contiguous()
        return self._wrap(blk, self.padded_n)

    def unpad(self, c):
        """Strip back to a DTensor of global shape (n, n). ONCE."""
        if self.padded_n == self.n:
            return c
        lay, n, p = self.layout, self.n, self.padded_n
        if p // lay.rows == -(-n // lay.rows) \
                and p // lay.cols == -(-n // lay.cols):
            # The padded blocks already lie in Shard's layout of (n, n):
            # each rank drops its padded rows and columns.
            br, bc = p // lay.rows, p // lay.cols
            local = c.to_local()[:max(0, min(br, n - lay.i * br)),
                                 :max(0, min(bc, n - lay.j * bc))]
        else:
            local = lay.block(c.full_tensor()[:n, :n])
        return self._wrap(local, n)

    # -- chain body (operand already padded + placed) ----------------------
    def mm(self, x, y):
        """x @ y on the padded sharded buffers; neither is written."""
        return self._wrap(self._local_fn(x.to_local(), y.to_local(),
                                         self.layout), self.padded_n)

    def square(self, x):
        """x @ x as one collective step; CONSUMES x when the chain donates
        (its block is the output buffer of the squaring after next)."""
        xl = x.to_local()
        out = None
        if self.donate:
            spare, self._spare = self._spare, xl
            if spare is not None and spare.shape == xl.shape \
                    and spare.dtype == xl.dtype \
                    and spare.device == xl.device \
                    and spare.data_ptr() != xl.data_ptr():
                out = spare
        return self._wrap(self._local_fn(xl, xl, self.layout, out),
                          self.padded_n)


def _check_power(n, what: str) -> None:
    if isinstance(n, bool):
        raise TypeError(f"{what} requires a static python int n, got bool")
    if not isinstance(n, int) or n < 0:
        raise ValueError(f"{what} requires a static python int n >= 0")


def matpow_sharded(a, n: int, mesh, *, algorithm: str = "auto",
                   row_axis: str = "data", col_axis: str = "model"):
    """A^n with A 2-D resident-sharded; ceil(log2 n) collective matmuls.

    The paper's squaring chain across a mesh, routed through
    :class:`ShardedMatmulChain`: one pad and placement, every squaring one
    collective step on the donated buffers, the popcount(n) - 1 combines
    un-donated (``core.matpow._binary_chain_body``, shared with the
    single-device chains), one unpad.

    Args:
      a: the (n, n) operand — the full matrix, the same on every rank, or a
        DTensor. Never written.
      n: static python int >= 0 (``n == 0`` returns the identity). A bool
        raises ``TypeError``.
      mesh: the ``DeviceMesh`` to keep A resident on; ``a`` must lie on its
        device type.
      algorithm: ``"auto"`` | ``"cannon"`` | ``"gather"``.
      row_axis, col_axis: mesh dim names for A's two dims.

    Returns:
      A^n as a DTensor of global shape (n, n), 2-D sharded over the mesh
      (``full_tensor()`` on every rank gathers it).
    """
    _check_power(n, "matpow_sharded")
    chain = ShardedMatmulChain(a.shape[-1], a.dtype, mesh,
                               algorithm=algorithm, row_axis=row_axis,
                               col_axis=col_axis)
    if n == 0:
        _check_device(a, mesh)
        # Built at the padded size, so every shard is even, then unpadded.
        eye = torch.eye(chain.padded_n, dtype=a.dtype, device=a.device)
        return chain.unpad(chain._wrap(chain.layout.block(eye).contiguous(),
                                       chain.padded_n))
    from repro_torch.core.matpow import _binary_chain_body
    return chain.unpad(_binary_chain_body(chain.pad(a), n, chain))


def _mesh_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` all-reduced to its maximum over every rank of the mesh (one
    collective per mesh dim of more than one rank), so that every rank
    takes the same branch on it."""
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        if dist.get_world_size(group) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def expm_sharded(a, mesh, *, max_squarings: int = 32,
                 algorithm: str = "auto", row_axis: str = "data",
                 col_axis: str = "model"):
    """Matrix exponential e^A with the squaring chain 2-D-sharded.

    The scaling-and-squaring structure of :func:`repro_torch.core.expm.
    expm`: the Pade-13 part (6 products and one solve, ``torch.matmul`` and
    ``torch.linalg.solve`` on the full matrix) runs on every rank alike, as
    the reference's solve gathers; s = ceil(log2(|A|_1 / theta)), clipped to
    ``max_squarings``, is agreed over the mesh and read once on the host;
    then ``s`` squarings on a ``donate=False`` :class:`ShardedMatmulChain`,
    each kept through ``torch.where`` (never a multiply-mask: an
    overflowing squaring times 0 would be NaN).

    Args:
      a: one (n, n) operand (the full matrix on every rank, or a DTensor).
      mesh / algorithm / row_axis / col_axis: as :func:`matpow_sharded`.
      max_squarings: clip on the data-dependent squaring count.

    Returns:
      e^A in ``a.dtype`` as a DTensor of global shape (n, n). Computes in
      float32 for f32/bf16/f16 and float64 for f64.
    """
    from torch.distributed.tensor import DTensor
    from repro_torch.core.expm import _THETA13, _pade13

    if isinstance(a, DTensor):
        a = a.full_tensor()
    if a.ndim != 2 or a.shape[-1] != a.shape[-2] or a.shape[-1] < 1:
        raise ValueError(f"expm_sharded needs one square matrix with n >= 1, "
                         f"got {tuple(a.shape)}")
    _check_device(a, mesh)
    dtype = a.dtype
    compute = a.to(torch.float64 if dtype == torch.float64
                   else torch.float32)
    exact_matmul_settings()

    norm = torch.linalg.matrix_norm(compute, ord=1)
    s = torch.clamp(torch.ceil(torch.log2(norm / _THETA13)), min=0.0)
    s = torch.clamp(s, max=float(max_squarings)).to(torch.int32)
    s = _mesh_max(s, mesh)
    scaled = compute / torch.pow(2.0, s.to(compute.dtype))

    ident = torch.eye(a.shape[-1], dtype=compute.dtype, device=a.device)
    u, v = _pade13(scaled, ident)
    r = torch.linalg.solve(v - u, v + u)

    # The mask needs each squaring's operand after the squaring: no
    # donation.
    chain = ShardedMatmulChain(a.shape[-1], compute.dtype, mesh,
                               algorithm=algorithm, row_axis=row_axis,
                               col_axis=col_axis, donate=False)
    r = chain.pad(r)
    for i in range(int(s)):
        sq = chain.square(r)
        r = chain._wrap(torch.where(i < s, sq.to_local(), r.to_local()),
                        chain.padded_n)
    return chain.unpad(r).to(dtype)
