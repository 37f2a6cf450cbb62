"""Parallel data-movement primitives with manually derived adjoints (paper
§3) over ``torch.distributed``; mirrors ``repro/core/primitives.py``.

Every operator here is *linear* in its data argument.  As in the paper, the
AD tool does not derive the backward rule: each primitive is a
``torch.autograd.Function`` whose ``backward`` is the adjoint derived by
hand, and autograd merely composes them:

  broadcast   B: replicated -> per-worker copies     B* = sum-reduce (Eq. 9)
  sum-reduce  R = B*        R* = B                   (paper §3)
  all-reduce  A = B R       A* = A                   (self-adjoint)
  all-gather  partitioned B, adjoint reduce-scatter (partitioned R)
  all-to-all  T (block permutation)  T* = reverse all-to-all
  send/recv   shift by an offset, adjoint = the reverse shift
  halo        H = K_T C_U C_E C_P K_S (Eq. 10)  H* adds into the bulk (Eq. 12)

Each device is one process (the paper's and DistDL's setting).  A paper
"partition" is a named dimension of a ``DeviceMesh``; a primitive acts on
this rank's local tensor and moves data over the process group of the
axis it names, resolved against the current mesh (``use_mesh``; ``spawn``
in ``launch/mesh.py`` sets it).  ``smap`` has no counterpart: the programs
are per rank already.  ``axis_size`` is the mesh dimension's size and
``axis_index`` this rank's position along it.

Cotangent convention, the one design decision of the port's distributed
layer (README, "Cotangent convention").  JAX's primitives store the
cotangent of a replicated value as per-device CONTRIBUTIONS whose sum is
the true cotangent (DESIGN.md §2.1), an artifact of ``shard_map``'s
boundary transposes: there ``broadcast`` is the identity both ways and its
B* is carried by a downstream psum, and ``batch_scatter``'s adjoint
slot-embeds without a psum.  Per-rank torch autograd follows the paper's
explicit-copy convention instead.  A value replicated over an axis is k
copies of one vector of F^n, and its cotangent is held in full, the same on
every rank.  So B is the identity forward and its adjoint B* is a real
sum-reduce (an all-reduce over the axis); R sums forward and its adjoint is
the identity; ``batch_scatter`` and ``shard_slice_replicated`` slice forward
and all-gather backward; ``grad_sum_reduce`` and ``all_gather_replicated``
all-gather forward and slice backward.  In this convention the two pairs
coincide, which is why the JAX package's replicated-cotangent pair
(DESIGN §4) maps onto them unchanged.  Per-rank cotangents therefore differ
from the reference's wherever a replicated value meets a rank; the global
values and the global Eq. 13 results do not, and those are what the parity
tests compare.

Communication stays on the tensor's device: NCCL for CUDA tensors, gloo for
host tensors (the mesh's backend follows its device, ``launch/mesh.py``),
and the fake backend for the dry run's ``meta`` tensors.

Every collective of the port goes through the raw layer below (and
``psum_``, ``pmax``, ``mesh_all_reduce_``), which records it in the
active shape trace (``repro_torch/tracing.py``): kind, mesh axis, the
group's global ranks, shapes, dim and output bytes.  That is the port's
collective inventory; ``tools/lint_repro_torch.py`` keeps every raw
``torch.distributed`` collective here or in ``launch/mesh.py``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.autograd import Function

from .. import tracing

__all__ = [
    "use_mesh",
    "current_mesh",
    "broadcast",
    "sum_reduce",
    "all_reduce",
    "all_gather",
    "all_gather_replicated",
    "shard_slice_replicated",
    "reduce_scatter",
    "all_to_all",
    "all_gather_replicated_v",
    "all_to_all_v",
    "send_recv",
    "ring_shift",
    "ring_hop_start",
    "resolve_axis",
    "batch_scatter",
    "grad_sum_reduce",
    "halo_exchange",
    "halo_accumulate",
    "halo_exchange_unbalanced",
    "halo_mask",
    "axis_size",
    "axis_index",
    "psum_",
    "pmax",
    "mesh_all_reduce_",
]

_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Resolve axis names against ``mesh`` inside the block."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The innermost mesh of ``use_mesh``; raises outside one."""
    if not _MESHES:
        raise RuntimeError("no current mesh: call inside use_mesh(mesh) "
                           "or a function run by launch.mesh.spawn")
    return _MESHES[-1]


@dataclass(frozen=True)
class _Axis:
    """One mesh axis as this rank sees it."""

    name: str
    group: object     # the axis's ProcessGroup
    size: int
    index: int        # this rank's position along the axis
    ranks: tuple      # the global ranks of the group, by position

    def peer(self, position: int) -> int:
        return self.ranks[position]


def _axis(name) -> _Axis:
    mesh = current_mesh()
    names = mesh.mesh_dim_names
    if name not in names:
        raise ValueError(f"mesh has no axis {name!r} (axes: {names})")
    group = mesh.get_group(names.index(name))
    ranks = tuple(dist.get_process_group_ranks(group))
    return _Axis(name, group, len(ranks), dist.get_rank(group), ranks)


def group_axis(group, name: str = "group") -> _Axis:
    """A process group (not a mesh axis) as an ``_Axis``, so a caller
    holding only a group (``core/adjoint.py``) still goes through the raw
    layer and its records."""
    ranks = tuple(dist.get_process_group_ranks(group))
    return _Axis(name, group, len(ranks), dist.get_rank(group), ranks)


def axis_size(axis_name) -> int:
    """Size of mesh axis ``axis_name`` of the current mesh."""
    return _axis(axis_name).size


def axis_index(axis_name) -> int:
    """This rank's position along mesh axis ``axis_name``."""
    return _axis(axis_name).index


# ---------------------------------------------------------------------------
# The data movement itself, on plain tensors (no autograd): forwards and
# hand-written adjoints are both written with these.  all_gather_into_tensor,
# reduce_scatter_tensor and all_to_all_single work on dim 0 of contiguous
# buffers, so other dims are moved to the front first.
# ---------------------------------------------------------------------------

# reduce_scatter_tensor, under the name newer torch gives it
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _front(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _record(kind: str, ax: _Axis, x, out, dim=None):
    """One collective into the active shape trace; nothing without one."""
    tracing.record_collective(kind, ax.name, ax.ranks, x, out, dim)


def _all_reduce(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=ax.group)
    _record("all-reduce", ax, x, out)
    return out


def _back(out: torch.Tensor, dim: int) -> torch.Tensor:
    """``out`` with its dim 0 moved back to ``dim``, contiguous: a result
    is a fresh array, as in JAX, never a permuted view (the kernels take
    contiguous rows)."""
    return out.movedim(0, dim).contiguous()


def _all_gather(x: torch.Tensor, ax: _Axis, dim: int,
                sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Tiled all-gather along ``dim``: the k blocks in axis order.  With
    unequal ``sizes`` (rank i holds ``sizes[i]`` of ``dim``: the balanced
    split of a dim the axis does not divide) it is one
    ``all_to_all_single`` that sends this rank's block to every rank,
    since gloo's all-gather takes equal blocks only; equal sizes take the
    even all-gather."""
    xt = _front(x, dim)
    if sizes is None or len(set(sizes)) == 1:
        out = xt.new_empty((ax.size * xt.shape[0],) + xt.shape[1:])
        dist.all_gather_into_tensor(out, xt, group=ax.group)
    else:
        if xt.shape[0] != sizes[ax.index]:
            raise ValueError(f"all_gather: dim {dim} size {xt.shape[0]}, "
                             f"rank {ax.index} of {ax.name!r} holds "
                             f"{sizes[ax.index]}")
        out = xt.new_empty((sum(sizes),) + xt.shape[1:])
        dist.all_to_all_single(out, torch.cat([xt] * ax.size),
                               output_split_sizes=list(sizes),
                               input_split_sizes=[xt.shape[0]] * ax.size,
                               group=ax.group)
    out = _back(out, dim)
    _record("all-gather", ax, x, out, dim)
    return out


def _reduce_scatter(x: torch.Tensor, ax: _Axis, dim: int,
                    sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Tiled reduce-scatter along ``dim``: block i of the sum to rank i.
    With unequal ``sizes`` (block i holds ``sizes[i]`` of ``dim``) one
    ``all_to_all_single`` sends block j to rank j and each rank sums the
    k blocks it received, in axis order; equal sizes take the even
    reduce-scatter."""
    xt = _front(x, dim)
    if sizes is None or len(set(sizes)) == 1:
        if xt.shape[0] % ax.size:
            raise ValueError(f"reduce_scatter: dim {dim} size {xt.shape[0]} "
                             f"not divisible by axis {ax.name!r} size "
                             f"{ax.size}")
        out = xt.new_empty((xt.shape[0] // ax.size,) + xt.shape[1:])
        _REDUCE_SCATTER(out, xt, group=ax.group)
    else:
        if xt.shape[0] != sum(sizes):
            raise ValueError(f"reduce_scatter: dim {dim} size {xt.shape[0]}, "
                             f"blocks {list(sizes)}")
        n = sizes[ax.index]
        recv = xt.new_empty((ax.size * n,) + xt.shape[1:])
        dist.all_to_all_single(recv, xt, output_split_sizes=[n] * ax.size,
                               input_split_sizes=list(sizes), group=ax.group)
        out = recv.view((ax.size, n) + xt.shape[1:]).sum(0)
    out = _back(out, dim)
    _record("reduce-scatter", ax, x, out, dim)
    return out


def _all_to_all(x: torch.Tensor, ax: _Axis, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """Split ``split_dim`` into k blocks, send block j to rank j, and
    concatenate the received blocks along ``concat_dim`` in axis order."""
    if x.shape[split_dim] % ax.size:
        raise ValueError(f"all_to_all: dim {split_dim} size "
                         f"{x.shape[split_dim]} not divisible by axis "
                         f"{ax.name!r} size {ax.size}")
    send = torch.stack(x.chunk(ax.size, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ax.group)
    out = torch.cat(recv.unbind(0), dim=concat_dim)
    _record("all-to-all", ax, x, out, concat_dim)
    return out


def _all_to_all_v(x: torch.Tensor, ax: _Axis, split_dim: int,
                  concat_dim: int, split_sizes: Sequence[int],
                  concat_sizes: Sequence[int]) -> torch.Tensor:
    """``_all_to_all`` of unequal blocks: ``split_dim`` cut into blocks of
    ``split_sizes`` (block j to rank j), and the block from rank i, which
    is ``concat_sizes[i]`` wide along ``concat_dim`` (this rank's
    ``x.shape[concat_dim]`` is ``concat_sizes[ax.index]``), concatenated
    along it in axis order.  Equal sizes on both sides take
    ``_all_to_all`` itself."""
    if len(set(split_sizes)) == 1 and len(set(concat_sizes)) == 1:
        return _all_to_all(x, ax, split_dim, concat_dim)
    if (x.shape[split_dim] != sum(split_sizes)
            or x.shape[concat_dim] != concat_sizes[ax.index]):
        raise ValueError(f"all_to_all_v: shape {tuple(x.shape)} against "
                         f"split {list(split_sizes)} on dim {split_dim}, "
                         f"rank {ax.index} of concat {list(concat_sizes)} "
                         f"on dim {concat_dim}")
    blocks = x.split(list(split_sizes), dim=split_dim)
    send = torch.cat([b.reshape(-1) for b in blocks])
    shapes = []
    for n in concat_sizes:
        shape = list(x.shape)
        shape[split_dim] = split_sizes[ax.index]
        shape[concat_dim] = n
        shapes.append(shape)
    counts = [math.prod(s) for s in shapes]
    recv = send.new_empty(sum(counts))
    dist.all_to_all_single(recv, send, output_split_sizes=counts,
                           input_split_sizes=[b.numel() for b in blocks],
                           group=ax.group)
    out = torch.cat([r.view(s) for r, s in zip(recv.split(counts), shapes)],
                    dim=concat_dim)
    _record("all-to-all", ax, x, out, concat_dim)
    return out


def _shift(x: torch.Tensor, ax: _Axis, offset: int, cyclic: bool,
           tag: int = 0) -> torch.Tensor:
    """Each rank sends ``x`` to the rank ``offset`` positions along the axis
    and receives the opposite neighbour's.  Non-cyclic: a rank with no
    source receives zeros (fresh allocation, paper §2) and a rank with no
    destination sends nothing.  All of a rank's sends and receives are
    posted in one batch, so neither side waits on the other's order."""
    return _shift_many([(x, offset)], ax, cyclic, tag)[0]


def _shift_many(items, ax: _Axis, cyclic: bool, tag: int = 0):
    """``_shift`` of several (tensor, offset) pairs in one batch of p2p
    operations; message j carries tag ``tag + j``."""
    ops, outs = [], []
    for j, (x, offset) in enumerate(items):
        x = x.contiguous()
        if cyclic:
            offset %= ax.size
        if offset == 0:
            outs.append(x.clone())
            continue
        out = torch.zeros_like(x)
        outs.append(out)
        dst, src = ax.index + offset, ax.index - offset
        if cyclic:
            dst, src = dst % ax.size, src % ax.size
        if 0 <= dst < ax.size:
            ops.append(dist.P2POp(dist.isend, x, ax.peer(dst), ax.group,
                                  tag + j))
        if 0 <= src < ax.size:
            ops.append(dist.P2POp(dist.irecv, out, ax.peer(src), ax.group,
                                  tag + j))
        if 0 <= dst < ax.size or 0 <= src < ax.size:
            _record("collective-permute", ax, x, out)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def resolve_axis(axis_name) -> _Axis:
    """Mesh axis ``axis_name`` as this rank sees it (its group, size, this
    rank's index), resolved against the current mesh NOW.  A ``Function``
    that communicates in its backward resolves in its forward: the backward
    runs after the region's ``use_mesh`` has exited."""
    return _axis(axis_name)


def ring_hop_start(x: torch.Tensor, ax: _Axis, offset: int = 1):
    """Post one hop of a cyclic shift by ``offset`` along the resolved axis
    ``ax`` and return at once: ``(buffer, requests)``.  The buffer holds
    the opposite neighbour's ``x`` after every request's ``wait()``; until
    then ``x`` must not change.  The ring matmuls (``core/overlap.py``) run
    a partial GEMM between the post and the wait.  No autograd: callers
    write the adjoint themselves."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dst, src = (ax.index + offset) % ax.size, (ax.index - offset) % ax.size
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ax.peer(dst), ax.group),
        dist.P2POp(dist.irecv, out, ax.peer(src), ax.group)])
    _record("collective-permute", ax, x, out)
    return out, reqs


def _block(x: torch.Tensor, ax: _Axis, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` split into ``ax.size`` equal blocks."""
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n).clone(
        memory_format=torch.contiguous_format)


def psum_(tensors, axes):
    """In place and outside autograd: every tensor of ``tensors`` summed
    over each mesh axis of ``axes`` in turn, the reference's ``psum`` over
    those axes.  An axis of size 1 is skipped (a sum over one rank is the
    identity).  Every rank of each axis calls it with the same tensors in
    the same order."""
    for name in axes:
        ax = _axis(name)
        if ax.size > 1:
            for t in tensors:
                dist.all_reduce(t, group=ax.group)
                _record("all-reduce", ax, t, t)
    return tensors


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise max of ``x`` over mesh axis ``axis_name``, out of
    place and outside autograd: the reference's ``pmax``.  Max is not
    linear, so it has no adjoint here; the flash-decoding combine uses it
    for the running max of the scores before the linear sum-reduce."""
    ax = _axis(axis_name)
    out = x.clone(memory_format=torch.contiguous_format)
    if ax.size > 1:
        dist.all_reduce(out, op=_REDUCE_OPS["max"], group=ax.group)
        _record("all-reduce", ax, x, out)
    return out


def mesh_all_reduce_(x: torch.Tensor, op: str = "sum", *,
                     replica: bool = False) -> torch.Tensor:
    """In place and outside autograd: ``x`` reduced (``"sum"`` or
    ``"max"``) over every rank of the current mesh by ONE all-reduce on
    the mesh's own group, the reference's ``psum``/``pmax`` over all of
    ``mesh.axis_names``.  The mesh carries that group as
    ``all_ranks_group`` (``launch.mesh`` makes it for the pipeline and
    hybrid meshes).  ``replica=True`` reduces over this rank's data
    replica only (every axis but ``data``, ``replica_group``): a value the
    replicas hold alike then comes out the same, bit for bit, whatever
    the data axis's size."""
    name = "replica_group" if replica else "all_ranks_group"
    group = getattr(current_mesh(), name, None)
    if group is None:
        raise ValueError(f"mesh_all_reduce_: the current mesh has no "
                         f"{name} (build it with launch.mesh's "
                         f"make_pipeline_mesh or make_hybrid_mesh)")
    dist.all_reduce(x, op=_REDUCE_OPS[op], group=group)
    if tracing.active() is not None:
        _record("all-reduce", group_axis(group, name), x, x)
    return x


# ---------------------------------------------------------------------------
# Broadcast / sum-reduce / all-reduce.  Paper Eq. 8-9 and §3, in the
# explicit-copy convention (module docstring).
# ---------------------------------------------------------------------------

class _Broadcast(Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # B* = R, the sum-reduction of the k copies' cotangents (Eq. 9); the
        # result is the replicated input's full cotangent on every rank.
        return _all_reduce(g, ctx.ax), None


def broadcast(x: torch.Tensor, axis_name) -> torch.Tensor:
    """B_{a->{k}}: a value replicated over ``axis_name`` becomes k per-worker
    copies (the identity on each rank); adjoint: sum-reduce (Eq. 9)."""
    return _Broadcast.apply(x, _axis(axis_name))


class _SumReduce(Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        # R* = B: the replicated cotangent, in full on every rank, is each
        # worker's copy.
        return g, None


def sum_reduce(x: torch.Tensor, axis_name) -> torch.Tensor:
    """R_{{k}->a}: sums the k per-worker realizations; the result is
    replicated over ``axis_name``.  Adjoint: broadcast (the identity)."""
    return _SumReduce.apply(x, _axis(axis_name))


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        # A* = R* B* = B R = A.
        return _all_reduce(g, ctx.ax), None


def all_reduce(x: torch.Tensor, axis_name) -> torch.Tensor:
    """A = B R, self-adjoint (paper §3): all-reduce both ways."""
    return _AllReduce.apply(x, _axis(axis_name))


# ---------------------------------------------------------------------------
# All-gather: the partitioned form of broadcast (each worker's subset is
# copied to all workers).  Adjoint = the partitioned sum-reduce, i.e.
# reduce-scatter.
# ---------------------------------------------------------------------------

class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, ax, dim, sizes):
        ctx.args = (ax, dim, sizes)
        return _all_gather(x, ax, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


def _sizes(sizes):
    return None if sizes is None else tuple(sizes)


def all_gather(x: torch.Tensor, axis_name, dim: int,
               sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Partitioned broadcast along tensor dim ``dim``; adjoint reduce-scatter
    with the same ``sizes``.  Each rank's gathered copy is its own (the
    output is stacked).  ``sizes`` gives each rank's block of ``dim`` where
    they differ (the balanced split of a dim the axis does not divide)."""
    return _AllGather.apply(x, _axis(axis_name), dim, _sizes(sizes))


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, ax, dim, sizes):
        ctx.args = (ax, dim, sizes)
        return _reduce_scatter(x, ax, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


def reduce_scatter(x: torch.Tensor, axis_name, dim: int,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Partitioned sum-reduce; adjoint = all-gather (partitioned broadcast)
    with the same ``sizes``: rank i gets the sum over the axis of block i
    of ``dim``, of ``sizes[i]`` where the blocks differ."""
    return _ReduceScatter.apply(x, _axis(axis_name), dim, _sizes(sizes))


# The replicated pair.  _GatherReplicated: stacked blocks -> one replicated
# value (forward all-gather); its cotangent arrives in full on every rank,
# so the adjoint restricts it to the rank's own block.  _SliceReplicated:
# the reverse restriction, whose adjoint all-gathers the blocks' cotangents
# into the replicated value's full cotangent.

class _GatherReplicated(Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.ax, ctx.dim), None, None


class _SliceReplicated(Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _block(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


def all_gather_replicated(x: torch.Tensor, axis_name, dim: int):
    """All-gather whose result is consumed IDENTICALLY on every worker.

    Same forward as ``all_gather``, different adjoint: the gathered value is
    replicated, so its cotangent is the full, equal gradient on every
    worker, and the adjoint is the *restriction* to the worker's own block,
    not a reduce-scatter, which would count the k identical copies k times
    (DESIGN §4).  In the port's convention this is ``grad_sum_reduce``.
    """
    return _GatherReplicated.apply(x, _axis(axis_name), dim)


def shard_slice_replicated(x: torch.Tensor, axis_name, dim: int):
    """Restriction of a REPLICATED value to the worker's own block.

    The inverse and adjoint of ``all_gather_replicated``: the forward slices
    worker i's block out of a value that is identical on every worker; the
    backward rebuilds the full, replicated cotangent by all-gathering the
    blocks' cotangents.  In the port's convention this is
    ``batch_scatter`` (without its divisibility check).
    """
    return _SliceReplicated.apply(x, _axis(axis_name), dim)


# ---------------------------------------------------------------------------
# Generalized all-to-all (paper §3): a block permutation matrix of
# send-receives; the adjoint is the reverse block permutation.
# ---------------------------------------------------------------------------

class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim):
        ctx.ax, ctx.split_dim, ctx.concat_dim = ax, split_dim, concat_dim
        return _all_to_all(x, ax, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        # The adjoint of a (block) permutation is its inverse permutation.
        return (_all_to_all(g, ctx.ax, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, axis_name, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Repartition: split local ``split_dim`` across workers, concatenate the
    received blocks along ``concat_dim`` (the paper's tensor 'shuffle')."""
    return _AllToAll.apply(x, _axis(axis_name), split_dim, concat_dim)


# ---------------------------------------------------------------------------
# Unequal blocks: the paper's balanced decomposition (``core/partition.py``,
# ``balanced_split``) of a dim the axis does not divide, e.g. query heads
# or d_model over the model axis.  The partitioned pair is ``all_gather``
# and ``reduce_scatter`` with ``sizes``.  The replicated gather's result is consumed identically on every rank, so its
# adjoint is the restriction to the rank's own block
# (``all_gather_replicated``'s); the v-style all-to-all is a block
# permutation, whose adjoint is the reverse all-to-all.
# ---------------------------------------------------------------------------

class _GatherReplicatedV(Function):
    @staticmethod
    def forward(ctx, x, ax, dim, sizes):
        ctx.ax, ctx.dim, ctx.sizes = ax, dim, sizes
        return _all_gather(x, ax, dim, sizes)

    @staticmethod
    def backward(ctx, g):
        lo = sum(ctx.sizes[:ctx.ax.index])
        own = g.narrow(ctx.dim, lo, ctx.sizes[ctx.ax.index]).clone(
            memory_format=torch.contiguous_format)
        return own, None, None, None


def all_gather_replicated_v(x: torch.Tensor, axis_name, dim: int,
                            sizes: Sequence[int]) -> torch.Tensor:
    """``all_gather_replicated`` of unequal blocks: rank i holds
    ``sizes[i]`` of ``dim``; the blocks concatenated in axis order, the
    result consumed identically on every rank.  Adjoint: the restriction
    to the rank's own block."""
    return _GatherReplicatedV.apply(x, _axis(axis_name), dim, tuple(sizes))


class _AllToAllV(Function):
    @staticmethod
    def forward(ctx, x, ax, split_dim, concat_dim, split_sizes,
                concat_sizes):
        ctx.args = (ax, concat_dim, split_dim, concat_sizes, split_sizes)
        return _all_to_all_v(x, ax, split_dim, concat_dim, split_sizes,
                             concat_sizes)

    @staticmethod
    def backward(ctx, g):
        # the reverse block permutation: each block back to its sender
        return (_all_to_all_v(g, *ctx.args),) + (None,) * 5


def all_to_all_v(x: torch.Tensor, axis_name, split_dim: int,
                 concat_dim: int, split_sizes: Sequence[int],
                 concat_sizes: Sequence[int]) -> torch.Tensor:
    """``all_to_all`` of unequal blocks: ``split_dim`` cut into blocks of
    ``split_sizes`` (block j to rank j); the block from rank i is
    ``concat_sizes[i]`` wide along ``concat_dim``, where this rank holds
    ``concat_sizes[axis_index]``.  Adjoint: ``all_to_all_v`` back, the
    roles of the two dims and their sizes swapped."""
    return _AllToAllV.apply(x, _axis(axis_name), split_dim, concat_dim,
                            tuple(split_sizes), tuple(concat_sizes))


# ---------------------------------------------------------------------------
# Send/receive (paper §3): a copy whose subsets live on different workers,
# non-periodic (send_recv) or cyclic (ring_shift).  The adjoint is the
# reverse shift: a receive-send pair.
# ---------------------------------------------------------------------------

class _Shift(Function):
    @staticmethod
    def forward(ctx, x, ax, offset, cyclic):
        ctx.ax, ctx.offset, ctx.cyclic = ax, offset, cyclic
        return _shift(x, ax, offset, cyclic)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.ax, -ctx.offset, ctx.cyclic), None, None, None


def send_recv(x: torch.Tensor, axis_name, offset: int) -> torch.Tensor:
    """Copy each worker's realization to the worker ``offset`` positions away
    (non-periodic); workers with no source receive zeros (fresh allocation,
    paper §2).  Adjoint: ``send_recv(axis, -offset)``."""
    return _Shift.apply(x, _axis(axis_name), offset, False)


def ring_shift(x: torch.Tensor, axis_name, offset: int) -> torch.Tensor:
    """Rotate each worker's realization ``offset`` positions around the ring
    (periodic: every worker sends and receives; no zeros appear).  A cyclic
    shift is orthogonal, so its adjoint is the reverse rotation,
    ``ring_shift(axis, -offset)``."""
    return _Shift.apply(x, _axis(axis_name), offset, True)


# ---------------------------------------------------------------------------
# Batch scatter / gradient sum-reduce: the data-parallel axis (paper Eq. 8-9
# applied block-wise to the batch).  S restricts a batch REPLICATED over the
# data axis to this replica's block; S* returns each replica's block to its
# global slot and sums the replicas (Eq. 9 on disjoint slots: a
# reassembly, realized as an all-gather).  Lifted globally both are the
# identity on F^B.
# ---------------------------------------------------------------------------

def batch_scatter(x: torch.Tensor, axis_name, dim: int) -> torch.Tensor:
    """S: restrict a replicated batch to this replica's block along ``dim``.
    Adjoint: the blocks' cotangents all-gathered into the replicated
    batch's full cotangent (``grad_sum_reduce``)."""
    ax = _axis(axis_name)
    if x.shape[dim] % ax.size:
        raise ValueError(
            f"batch_scatter: dim {dim} size {x.shape[dim]} not divisible by "
            f"axis {axis_name!r} size {ax.size}: a clamped slice would "
            f"silently drop the trailing rows")
    return _SliceReplicated.apply(x, ax, dim)


def grad_sum_reduce(y: torch.Tensor, axis_name, dim: int) -> torch.Tensor:
    """S* = batch_scatter's adjoint: each replica's block returns to its
    global batch slot and the replicas sum (Eq. 9); the result is the full
    global-dim tensor, replicated over ``axis_name``.  The slots are
    disjoint, so the sum is a tiled all-gather.  Adjoint: the restriction
    to the replica's own slot (S** = S)."""
    return _GatherReplicated.apply(y, _axis(axis_name), dim)


# ---------------------------------------------------------------------------
# Halo exchange (paper Eq. 10-12, Appendix B).
#
# Uniform-width form: each worker owns a bulk of extent B along ``dim`` and
# receives a left margin (its left neighbour's last ``left`` entries) and a
# right margin (its right neighbour's first ``right`` entries).  Boundary
# margins are zero (the layer materializes global padding).  The adjoint
# H* (Eq. 12) reverses every copy: margin cotangents travel back to the
# neighbour that owns the data and ADD into its bulk.
# ---------------------------------------------------------------------------

def _halo_exchange(x, ax, dim, left, right):
    n = x.shape[dim]
    items = []
    if left > 0:    # left margin <- left neighbour's last `left` entries
        items.append((x.narrow(dim, n - left, left), +1))
    if right > 0:   # right margin <- right neighbour's first `right` entries
        items.append((x.narrow(dim, 0, right), -1))
    margins = _shift_many(items, ax, cyclic=False)
    lm = [margins.pop(0)] if left > 0 else []
    return torch.cat(lm + [x] + margins, dim=dim)


def _halo_accumulate(y, ax, dim, left, right):
    bulk = y.shape[dim] - left - right
    items = []
    if left > 0:    # left-margin cotangent back to the left neighbour
        items.append((y.narrow(dim, 0, left), -1))
    if right > 0:   # right-margin cotangent back to the right neighbour
        items.append((y.narrow(dim, left + bulk, right), +1))
    back = _shift_many(items, ax, cyclic=False)
    x_bar = y.narrow(dim, left, bulk).clone(
        memory_format=torch.contiguous_format)
    if left > 0:
        x_bar.narrow(dim, bulk - left, left).add_(back.pop(0))
    if right > 0:
        x_bar.narrow(dim, 0, right).add_(back.pop(0))
    return x_bar


class _HaloExchange(Function):
    @staticmethod
    def forward(ctx, x, ax, dim, left, right):
        ctx.args = (ax, dim, left, right)
        return _halo_exchange(x, ax, dim, left, right)

    @staticmethod
    def backward(ctx, g):
        # H*: margins travel back to the owning neighbour and ADD into its
        # bulk (Eq. 12).
        return (_halo_accumulate(g, *ctx.args),) + (None,) * 4


class _HaloAccumulate(Function):
    @staticmethod
    def forward(ctx, y, ax, dim, left, right):
        ctx.args = (ax, dim, left, right)
        return _halo_accumulate(y, ax, dim, left, right)

    @staticmethod
    def backward(ctx, g):
        # (H*)* = H: the cotangent's margins are re-fetched from neighbours.
        return (_halo_exchange(g, *ctx.args),) + (None,) * 4


def halo_exchange(x: torch.Tensor, axis_name, dim: int, left: int,
                  right: int) -> torch.Tensor:
    """H: bulk-only local tensor -> [left margin | bulk | right margin]."""
    return _HaloExchange.apply(x, _axis(axis_name), dim, left, right)


def halo_accumulate(y: torch.Tensor, axis_name, dim: int, left: int,
                    right: int) -> torch.Tensor:
    """H* (paper Eq. 12) as a first-class forward operator.

    Takes a margin-augmented local tensor [left margin | bulk | right
    margin] and returns the bulk with each margin sent back to the
    neighbour that owns the data and ADDED into its bulk: the adjoint of
    ``halo_exchange`` with the same widths.  Its own backward closes the
    pair (H** = H).
    """
    return _HaloAccumulate.apply(y, _axis(axis_name), dim, left, right)


def halo_mask(shape, dim: int, index: int, left_widths: Sequence[int],
              right_widths: Sequence[int], device) -> torch.Tensor:
    """The diagonal operator of the unbalanced halo (paper App. B) for the
    worker at ``index``: on a buffer with max-width margins, keep that
    worker's [lmax - lw, lmax + bulk + rw) lanes along ``dim``."""
    lmax, rmax = int(max(left_widths)), int(max(right_widths))
    bulk = shape[dim] - lmax - rmax
    pos = torch.arange(shape[dim], device=device)
    keep = ((pos >= lmax - int(left_widths[index]))
            & (pos < lmax + bulk + int(right_widths[index])))
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return keep.view(view)


class _HaloUnbalanced(Function):
    @staticmethod
    def forward(ctx, x, ax, dim, left_widths, right_widths):
        lmax, rmax = int(max(left_widths)), int(max(right_widths))
        ctx.args = (ax, dim, lmax, rmax)
        y = _halo_exchange(x, ax, dim, lmax, rmax)
        ctx.mask = halo_mask(y.shape, dim, ax.index, left_widths,
                             right_widths, y.device)
        return y * ctx.mask

    @staticmethod
    def backward(ctx, g):
        # (D H)* = H* D: the mask is diagonal, hence self-adjoint.
        return (_halo_accumulate(g * ctx.mask, *ctx.args),) + (None,) * 4


def halo_exchange_unbalanced(
    x: torch.Tensor,
    axis_name,
    dim: int,
    left_widths: Sequence[int],
    right_widths: Sequence[int],
) -> torch.Tensor:
    """Generalized unbalanced halo exchange (paper App. B).

    ``left_widths[i]`` / ``right_widths[i]`` give worker i's true halo
    thicknesses (from ``partition.compute_halos``).  Buffers are uniform at
    the max width; a per-worker diagonal mask zeroes the unused lanes, so
    the composite remains a linear operator with an exact adjoint.

    Returns the local tensor with max-width margins attached; entries beyond
    a worker's true halo width are zero.
    """
    return _HaloUnbalanced.apply(x, _axis(axis_name), dim,
                                 tuple(left_widths), tuple(right_widths))
