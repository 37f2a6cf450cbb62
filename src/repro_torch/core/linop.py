"""Operator algebra: composable, adjoint-aware linear operators (paper §2-3);
mirrors ``repro/core/linop.py``.

The paper's central claim is that parallel data movement *is* linear
algebra: broadcast, sum-reduce, halo exchange are linear operators whose
adjoints compose by reversal, ``(A B)* = B* A*``.  ``primitives.py`` holds
the per-rank data movement; this module reifies it as first-class objects
so composition, adjoint pairing and mesh metadata live in ONE place
instead of being re-derived at every call site.

Each ``LinearOp``:

- is callable on this rank's local tensor (``op(x)``), with its axes
  resolved against the current mesh (``primitives.use_mesh``),
- carries its mesh-axis / tensor-dim / width metadata as frozen dataclass
  fields (so ops compare equal structurally),
- exposes its hand-derived adjoint as ``op.T``, registered ONCE, here, per
  operator class (paper §3's manual-adjoint table),
- composes with ``@``: ``(A @ B)(x) == A(B(x))`` and the reversal law
  ``(A @ B).T == B.T @ A.T`` holds by construction,
- declares canonical boundary specs ``in_spec(rank)`` / ``out_spec(rank)``
  describing how a GLOBAL array maps onto per-worker shards when the op is
  lifted to a global operator F (the paper's "inclusive" memory view: the
  global vector is the concatenation of the workers' local states),
- declares a STATIC space signature via ``space_map(space, axis_sizes)``:
  which global vector space (:class:`Space`: replicated F^n vs k-worker
  stacked F^{kn}) it consumes and which it produces.  ``Compose`` rejects
  kind-mismatched junctions at construction time.

How a :class:`Space` lies in per-rank storage (the port's cotangent
convention, ``primitives.py``): a replicated space F^n is one tensor of
``local_shape``, the same on every rank, and counts once in an inner
product; a space stacked over ``axis`` at ``dim`` is the concatenation
along ``dim`` of the ranks' local tensors in axis order, and its inner
product all-reduces the local partial sums over the axis.

``check_adjoint`` is the generic Eq. 13 harness: for any op (or composite)
it scatters a global input to the ranks by the op's specs and verifies BOTH

  (a)  <F x, y> == <x, op.T y>     (the registered adjoint is THE adjoint),
  (b)  torch.autograd through F agrees with Eq. 13 (the backwards written
       by hand in the primitives are coherent with the forwards: the
       paper's original test).

The adjoint pairing and the reversal law are structural (frozen-dataclass
equality), so they hold without touching a device::

    >>> AllGather("tp", 1).T == ReduceScatter("tp", 1)
    True
    >>> (AllGather("tp", 1) @ ReduceScatter("tp", 0)).T == (
    ...     AllGather("tp", 0) @ ReduceScatter("tp", 1))
    True
    >>> AllReduce("tp").T == AllReduce("tp")
    True
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from . import primitives as prim
from .adjoint import AdjointReport, adjoint_test, rel_err


class PartitionSpec(tuple):
    """The port's stand-in for ``jax.sharding.PartitionSpec``: entry d names
    the mesh axis that tensor dim d is split over (None: not split).

    >>> PartitionSpec(None, "model")
    P(None, 'model')
    """

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec

__all__ = [
    "Space",
    "SpaceTypeError",
    "LinearOp",
    "Identity",
    "Broadcast",
    "SumReduce",
    "AllReduce",
    "AllGather",
    "ReduceScatter",
    "AllToAll",
    "SendRecv",
    "KVRingShift",
    "BatchScatter",
    "GradSumReduce",
    "Layout",
    "Repartition",
    "CapacityRestrict",
    "HaloExchange",
    "HaloAccumulate",
    "Compose",
    "PartitionSpec",
    "check_adjoint",
    "check_adjoint_pair",
    "lift",
    "scatter",
    "assemble",
    "space_of",
    "axis_sizes",
    "spec_groups",
]


def _axis_at(axis, dim: int, rank: int) -> P:
    """PartitionSpec with ``axis`` at position ``dim`` and None elsewhere."""
    if dim >= rank:
        raise ValueError(f"op acts on dim {dim} but rank is {rank}")
    return P(*[axis if i == dim else None for i in range(rank)])


class SpaceTypeError(TypeError):
    """An operator was applied outside its domain space (paper §2).

    The paper's operators are maps between SPECIFIC global vector spaces —
    replicated F^n vs k-worker-stacked F^{kn} — so e.g. ``Broadcast`` after
    ``AllReduce`` over the same axis is ill-typed: the value is already
    stacked.  Raised structurally by ``Compose`` at construction time and
    by ``space_map`` with full shard-shape accuracy.
    """


@dataclass(frozen=True)
class Space:
    """A global vector space of the paper's §2 inclusive memory view.

    ``kind == "replicated"``: every worker holds the same F^n value of local
    shape ``local_shape`` (``axis``/``dim`` are None).  ``kind == "stacked"``:
    the global vector is the concatenation of k per-worker realizations over
    mesh ``axis``, stacked along tensor ``dim`` — the global array is
    ``local_shape`` with ``dim`` scaled by k.
    """

    kind: str
    local_shape: Tuple[int, ...]
    axis: str | None = None
    dim: int | None = None

    @classmethod
    def replicated(cls, local_shape) -> "Space":
        """The replicated space F^n with per-worker shape ``local_shape``."""
        return cls("replicated", tuple(int(d) for d in local_shape))

    @classmethod
    def stacked(cls, axis: str, dim: int, local_shape) -> "Space":
        """The ``axis``-stacked space F^{kn}, stacking along tensor ``dim``."""
        shape = tuple(int(d) for d in local_shape)
        if not 0 <= dim < len(shape):
            raise SpaceTypeError(
                f"stacking dim {dim} out of range for local shape {shape}")
        return cls("stacked", shape, axis, int(dim))

    def global_shape(self, axis_sizes=None) -> Tuple[int, ...]:
        """Shape of the global array (stacked dim scaled by the axis size)."""
        if self.kind == "replicated":
            return self.local_shape
        k = (axis_sizes if isinstance(axis_sizes, int)
             else int(axis_sizes[self.axis]))
        g = list(self.local_shape)
        g[self.dim] *= k
        return tuple(g)

    def describe(self) -> str:
        """Human-readable form used in typechecker diagnostics."""
        if self.kind == "replicated":
            return f"replicated F^n, local shape {self.local_shape}"
        return (f"stacked F^(kn) over '{self.axis}' at dim {self.dim}, "
                f"local shape {self.local_shape}")


def _axis_size(op, axis_sizes) -> int:
    """The size k of ``op.axis``: from an int or a {axis: size} mapping."""
    if isinstance(axis_sizes, int):
        return axis_sizes
    try:
        return int(axis_sizes[op.axis])
    except KeyError:
        raise SpaceTypeError(
            f"{op!r} acts over mesh axis '{op.axis}' which is not in the "
            f"mesh (axes: {sorted(axis_sizes)})") from None


def _expect_replicated(op, space: Space):
    if space.kind != "replicated":
        raise SpaceTypeError(
            f"{op!r} consumes the replicated space F^n, got {space.describe()}"
            " — reduce or gather first")


def _expect_stacked(op, space: Space, dim: int | None = None):
    if space.kind != "stacked":
        raise SpaceTypeError(
            f"{op!r} consumes the '{op.axis}'-stacked space F^(kn), got "
            f"{space.describe()} — broadcast or scatter first")
    if space.axis != op.axis:
        raise SpaceTypeError(
            f"{op!r} acts over mesh axis '{op.axis}' but the value is stacked "
            f"over '{space.axis}' (single-axis space model: reduce or gather "
            f"'{space.axis}' first)")
    if dim is not None and space.dim != dim:
        raise SpaceTypeError(
            f"{op!r} expects stacking along tensor dim {dim}, got "
            f"{space.describe()}")


def _expect_dim(op, space: Space, dim: int):
    if not 0 <= dim < len(space.local_shape):
        raise SpaceTypeError(
            f"{op!r} acts on tensor dim {dim} but the local shape is "
            f"{space.local_shape}")


def _expect_divisible(op, space: Space, dim: int, k: int):
    if space.local_shape[dim] % k:
        raise SpaceTypeError(
            f"{op!r} splits tensor dim {dim} into {k} blocks but the local "
            f"extent is {space.local_shape[dim]} (not divisible)")


@dataclass(frozen=True)
class LinearOp:
    """A linear operator on per-worker shards, with a registered adjoint.

    Subclasses implement ``__call__`` (the per-rank forward, its axes
    resolved against the current mesh) and ``_adjoint`` (the hand-derived
    adjoint, returned by ``.T``).  All metadata lives in frozen dataclass fields, so
    equality is structural — ``(A @ B).T == B.T @ A.T`` is an actual ``==``.

    ``DOMAIN_KIND``/``CODOMAIN_KIND`` ("replicated" | "stacked" | "any") are
    the kind-level space signature used by ``Compose`` to reject ill-typed
    junctions structurally; ``space_map`` is the full shard-shape-accurate
    typing judgment (DESIGN §7).
    """

    DOMAIN_KIND = "any"
    CODOMAIN_KIND = "any"

    def __call__(self, x):
        raise NotImplementedError

    def _adjoint(self) -> "LinearOp":
        raise NotImplementedError

    def space_map(self, space: Space, axis_sizes) -> Space:
        """Codomain :class:`Space` for input ``space``, or SpaceTypeError.

        ``axis_sizes`` is the op's own mesh-axis size (int) or a
        ``{axis: size}`` mapping.  Every concrete op defines (or, like
        ``pipeline.StageBoundary``, inherits) a real signature; the base
        refuses so an unsigned op can never slip through ``typecheck``.
        """
        raise NotImplementedError(
            f"{type(self).__name__} declares no space signature")

    @property
    def T(self) -> "LinearOp":
        """The paper's ``*`` adjoint."""
        return self._adjoint()

    def __matmul__(self, other: "LinearOp") -> "LinearOp":
        a = self.ops if isinstance(self, Compose) else (self,)
        b = other.ops if isinstance(other, Compose) else (other,)
        return Compose(a + b)

    # Canonical global-lift boundary specs (rank-parametric).
    def in_spec(self, rank: int) -> P:
        return P()

    def out_spec(self, rank: int) -> P:
        return P()


@dataclass(frozen=True)
class Compose(LinearOp):
    """``Compose((A, B, C))(x) == A(B(C(x)))`` — matrix-product order.

    Adjoint: the paper §2 reversal law ``(A B)* = B* A*``, held structurally
    (``(A @ B).T == B.T @ A.T`` is an actual ``==``).

    Construction rejects kind-mismatched junctions (e.g. ``Broadcast`` fed
    by ``AllReduce`` over the same axis: the value is already stacked) with
    a :class:`SpaceTypeError`: ill-typed programs fail before any data
    moves.  Shard-shape-accurate checking is ``space_map``.
    """

    ops: Tuple[LinearOp, ...]

    def __post_init__(self):
        if not self.ops:
            raise SpaceTypeError("empty composite")
        for i in range(len(self.ops) - 1):
            # ops[i+1] is applied BEFORE ops[i] (matrix-product order).
            _check_junction(producer=_applied_last(self.ops[i + 1]),
                            consumer=_applied_first(self.ops[i]))

    def __call__(self, x):
        for op in reversed(self.ops):
            x = op(x)
        return x

    def _adjoint(self) -> "LinearOp":
        # (A B)* = B* A* — adjoints compose by reversal (paper §2).
        return Compose(tuple(op.T for op in reversed(self.ops)))

    def space_map(self, space: Space, axis_sizes) -> Space:
        """Fold the constituents' signatures in application order."""
        for i, op in enumerate(reversed(self.ops)):
            try:
                space = op.space_map(space, axis_sizes)
            except SpaceTypeError as e:
                raise SpaceTypeError(
                    f"position {i} (application order), {op!r}: {e}") from None
        return space

    def in_spec(self, rank: int) -> P:
        return self.ops[-1].in_spec(rank)

    def out_spec(self, rank: int) -> P:
        return self.ops[0].out_spec(rank)


def _applied_first(op: LinearOp) -> LinearOp:
    """The constituent that touches the input first (innermost)."""
    return _applied_first(op.ops[-1]) if isinstance(op, Compose) else op


def _applied_last(op: LinearOp) -> LinearOp:
    """The constituent that produces the output (outermost)."""
    return _applied_last(op.ops[0]) if isinstance(op, Compose) else op


def _check_junction(producer: LinearOp, consumer: LinearOp):
    """Kind-level junction check: producer's codomain vs consumer's domain.

    Only same-axis junctions are decidable without shapes: a value may be
    stacked over one axis and replicated over another, so cross-axis
    junctions defer to the shape-accurate ``space_map``.
    """
    pk, ck = producer.CODOMAIN_KIND, consumer.DOMAIN_KIND
    if "any" in (pk, ck) or pk == ck:
        return
    pax = getattr(producer, "axis", None)
    cax = getattr(consumer, "axis", None)
    if pax is None or cax is None or pax != cax:
        return
    raise SpaceTypeError(
        f"ill-typed composite over axis '{cax}': {consumer!r} consumes the "
        f"{ck} space but {producer!r} produces the {pk} space (paper §2: "
        f"operators are maps between specific global spaces — insert the "
        f"appropriate broadcast/reduce/gather)")


@dataclass(frozen=True)
class Identity(LinearOp):
    """I — neutral element of the algebra (paper §2); adjoint: I* = I."""

    def __call__(self, x):
        return x

    def _adjoint(self):
        return self

    def space_map(self, space, axis_sizes):
        """I is the identity on any space."""
        return space

    def in_spec(self, rank):
        return P()

    def out_spec(self, rank):
        return P()


@dataclass(frozen=True)
class Broadcast(LinearOp):
    """B_{1->k} over ``axis`` (paper Eq. 8): one copy in, k copies out.

    The per-rank forward is the identity on a replicated value; lifted globally
    (in_spec replicated, out_spec stacked) it is F^m -> F^{km}.  Adjoint:
    the Eq. 9 sum-reduction.
    """

    axis: str

    DOMAIN_KIND = "replicated"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.broadcast(x, self.axis)

    def _adjoint(self):
        return SumReduce(self.axis)

    def space_map(self, space, axis_sizes):
        """F^n -> F^{kn}: one copy in, k stacked copies out (Eq. 8)."""
        _expect_replicated(self, space)
        return Space.stacked(self.axis, 0, space.local_shape)

    def in_spec(self, rank):
        return P()

    def out_spec(self, rank):
        return _axis_at(self.axis, 0, rank)


@dataclass(frozen=True)
class SumReduce(LinearOp):
    """R_{k->1} over ``axis`` (paper §3): sums the k per-worker realizations;
    the result is replicated.  R = B*, R* = B."""

    axis: str

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "replicated"

    def __call__(self, x):
        return prim.sum_reduce(x, self.axis)

    def _adjoint(self):
        return Broadcast(self.axis)

    def space_map(self, space, axis_sizes):
        """F^{kn} -> F^n: the k realizations sum into one (Eq. 9)."""
        _expect_stacked(self, space, dim=0)
        return Space.replicated(space.local_shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, 0, rank)

    def out_spec(self, rank):
        return P()


@dataclass(frozen=True)
class AllReduce(LinearOp):
    """A = B·R (paper §3); self-adjoint: A* = R*·B* = B·R = A."""

    axis: str

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.all_reduce(x, self.axis)

    def _adjoint(self):
        return self

    def space_map(self, space, axis_sizes):
        """F^{kn} -> F^{kn}: an endomorphism of the stacked space."""
        _expect_stacked(self, space, dim=0)
        return space

    def in_spec(self, rank):
        return _axis_at(self.axis, 0, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, 0, rank)


@dataclass(frozen=True)
class AllGather(LinearOp):
    """Partitioned broadcast along tensor ``dim`` (paper §3: B applied
    block-wise, each worker's subset copied to all).  Adjoint: the
    partitioned Eq. 9 sum-reduction, ``ReduceScatter(axis, dim)``."""

    axis: str
    dim: int = 0

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.all_gather(x, self.axis, self.dim)

    def _adjoint(self):
        return ReduceScatter(self.axis, self.dim)

    def space_map(self, space, axis_sizes):
        """Stacked at ``dim`` -> stacked at ``dim``, local extent times k."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.dim)
        shape = list(space.local_shape)
        shape[self.dim] *= k
        return Space.stacked(self.axis, self.dim, shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)


@dataclass(frozen=True)
class ReduceScatter(LinearOp):
    """Partitioned sum-reduce along ``dim`` (paper §3: R applied block-wise).
    Adjoint: the partitioned broadcast, ``AllGather(axis, dim)`` — the R*/B
    pair of Eq. 9 on blocks."""

    axis: str
    dim: int = 0

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.reduce_scatter(x, self.axis, self.dim)

    def _adjoint(self):
        return AllGather(self.axis, self.dim)

    def space_map(self, space, axis_sizes):
        """Stacked at ``dim`` -> stacked at ``dim``, local extent over k."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.dim)
        _expect_divisible(self, space, self.dim, k)
        shape = list(space.local_shape)
        shape[self.dim] //= k
        return Space.stacked(self.axis, self.dim, shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)


@dataclass(frozen=True)
class AllToAll(LinearOp):
    """Generalized all-to-all (paper §3): a block permutation; the adjoint
    is the reverse block permutation (split/concat dims swapped)."""

    axis: str
    split_dim: int
    concat_dim: int

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.all_to_all(x, self.axis, self.split_dim, self.concat_dim)

    def _adjoint(self):
        return AllToAll(self.axis, self.concat_dim, self.split_dim)

    def space_map(self, space, axis_sizes):
        """Stacking moves from ``concat_dim`` to ``split_dim`` (a block
        permutation): concat extent times k, split extent over k."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.concat_dim)
        _expect_dim(self, space, self.split_dim)
        _expect_divisible(self, space, self.split_dim, k)
        shape = list(space.local_shape)
        shape[self.concat_dim] *= k
        shape[self.split_dim] //= k
        return Space.stacked(self.axis, self.split_dim, shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.concat_dim, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, self.split_dim, rank)


@dataclass(frozen=True)
class SendRecv(LinearOp):
    """Non-periodic ring shift by ``offset`` (paper §3 send/receive; absent
    sources yield zeros — the §2 fresh-allocation convention).  Adjoint:
    ``SendRecv(axis, -offset)``, the reverse shift.  Subclassed by
    ``pipeline.StageBoundary`` for stage-to-stage movement."""

    axis: str
    offset: int = 1

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.send_recv(x, self.axis, self.offset)

    def _adjoint(self):
        return SendRecv(self.axis, -self.offset)

    def space_map(self, space, axis_sizes):
        """A (nilpotent-shift) endomorphism of the stacked space."""
        _expect_stacked(self, space, dim=0)
        return space

    def in_spec(self, rank):
        return _axis_at(self.axis, 0, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, 0, rank)


@dataclass(frozen=True)
class KVRingShift(LinearOp):
    """Cyclic ring shift by ``offset`` around ``axis`` (paper §3; DESIGN §6).

    The PERIODIC sibling of :class:`SendRecv`: every worker sends its
    realization ``offset`` positions around the ring and receives one from
    the opposite neighbour — a (block) permutation matrix, hence orthogonal.
    Adjoint: the inverse permutation, ``KVRingShift(axis, -offset)`` — the
    reverse ring.  This is the KV-shard rotation of ring attention
    (``core/ring_attention.py``): the forward pass rotates K/V shards one
    hop per step around the ``ctx`` mesh axis, and AD composes the
    registered reverse-ring adjoints into the backward rotation.  Eq. 13-
    checked on 1-D and 4-D meshes (tests/md/test_linop.py) and sampled by
    the property fuzzer (tests/md/test_adjoint_property.py).

    >>> KVRingShift("ctx", 1).T == KVRingShift("ctx", -1)
    True
    >>> (KVRingShift("ctx", 2).T).T == KVRingShift("ctx", 2)
    True
    """

    axis: str
    offset: int = 1

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.ring_shift(x, self.axis, self.offset)

    def _adjoint(self):
        return KVRingShift(self.axis, -self.offset)

    def space_map(self, space, axis_sizes):
        """An orthogonal (block-permutation) endomorphism of the stacked
        space."""
        _expect_stacked(self, space, dim=0)
        return space

    def in_spec(self, rank):
        return _axis_at(self.axis, 0, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, 0, rank)


@dataclass(frozen=True)
class BatchScatter(LinearOp):
    """S: per-replica batch distribution over the ``data`` axis (paper
    Eq. 8-9 block-wise on the batch; DESIGN §5).  Restricts a replicated
    batch to this replica's own block along ``dim``.  Adjoint:
    ``GradSumReduce(axis, dim)`` — cotangent blocks return to their global
    batch slots and the replica contributions sum (Eq. 9).  Lifted globally
    both are the identity on F^B: the data axis moves no batch bytes; its
    cost is the parameter-path B/R pair."""

    axis: str
    dim: int = 0

    DOMAIN_KIND = "replicated"
    CODOMAIN_KIND = "stacked"

    def __call__(self, x):
        return prim.batch_scatter(x, self.axis, self.dim)

    def _adjoint(self):
        return GradSumReduce(self.axis, self.dim)

    def space_map(self, space, axis_sizes):
        """Replicated batch -> per-replica blocks stacked at ``dim``."""
        k = _axis_size(self, axis_sizes)
        _expect_replicated(self, space)
        _expect_dim(self, space, self.dim)
        _expect_divisible(self, space, self.dim, k)
        shape = list(space.local_shape)
        shape[self.dim] //= k
        return Space.stacked(self.axis, self.dim, shape)

    def in_spec(self, rank):
        return P()

    def out_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)


@dataclass(frozen=True)
class GradSumReduce(LinearOp):
    """S* (DESIGN §5): sum slot-embedded per-replica contributions back into
    the global batch — batch_scatter's Eq. 9 adjoint.  The result is the
    full global-dim tensor, replicated over ``axis``.  Adjoint:
    ``BatchScatter(axis, dim)`` (S** = S)."""

    axis: str
    dim: int = 0

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "replicated"

    def __call__(self, y):
        return prim.grad_sum_reduce(y, self.axis, self.dim)

    def _adjoint(self):
        return BatchScatter(self.axis, self.dim)

    def space_map(self, space, axis_sizes):
        """Per-replica blocks -> the replicated global batch (Eq. 9)."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.dim)
        shape = list(space.local_shape)
        shape[self.dim] *= k
        return Space.replicated(shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)

    def out_spec(self, rank):
        return P()


@dataclass(frozen=True)
class Layout:
    """Where a global tensor lives: ``axis is None`` means replicated over
    the mesh (the F^n view); otherwise stacked over mesh ``axis`` along
    tensor ``dim`` (the F^{kn} view).  The replicated layout normalizes
    ``dim`` to 0 so :class:`Repartition` adjoints compare structurally
    (``Repartition(a, b).T.T == Repartition(a, b)`` is an actual ``==``).

    >>> Layout(None, 3) == Layout(None, 0)
    True
    >>> Layout("data", 1).axis, Layout("data", 1).dim
    ('data', 1)
    """

    axis: str | None = None
    dim: int = 0

    def __post_init__(self):
        if self.axis is None:
            object.__setattr__(self, "dim", 0)
        elif self.dim < 0:
            raise SpaceTypeError(
                f"Layout dim must be non-negative, got {self.dim}")

    def describe(self) -> str:
        """Human-readable form used in repartition-plan diagnostics."""
        if self.axis is None:
            return "replicated"
        return f"stacked over '{self.axis}' at dim {self.dim}"


@dataclass(frozen=True)
class Repartition(LinearOp):
    """T: general partition-to-partition movement (paper §4, DistDL's
    distributed transpose) — the ONE operator that carries a tensor from
    any :class:`Layout` to any other while fixing the global value.

    Realized as a composition of the existing pieces, chosen by the
    (src, dst) layout pair:

    - same layout                      -> ``Identity``
    - replicated -> stacked(a, d)      -> ``BatchScatter(a, d)``
    - stacked(a, d) -> replicated      -> ``GradSumReduce(a, d)``
    - stacked(a, d1) -> stacked(a, d2) -> ``AllToAll(a, d2, d1)``
    - stacked(a, d1) -> stacked(b, d2) -> ``BatchScatter(b, d2)``
                                          after ``GradSumReduce(a, d1)``
                                          (through the replicated space)

    Every piece is globally the identity map on the inclusive-memory view,
    so T is a pure re-layout: same global vector, different partition.
    Adjoint: the REVERSE repartition ``Repartition(dst, src)`` — each
    piece's registered adjoint is exactly the piece of the reverse path,
    so ``(T)* = T^{-1}`` here (re-layouts are orthogonal maps).  The
    elastic checkpoint reshard (``checkpoint/ckpt.py::restore_resharded``)
    drives every leaf through one of these plans.

    >>> Repartition(Layout("data"), Layout("model", 1)).T == Repartition(
    ...     Layout("model", 1), Layout("data"))
    True
    >>> Repartition(Layout(None), Layout("data")).T.T == Repartition(
    ...     Layout(None), Layout("data"))
    True
    >>> Repartition(Layout("ep", 1), Layout("ep", 0)).pieces()
    (AllToAll(axis='ep', split_dim=0, concat_dim=1),)
    """

    src: Layout
    dst: Layout

    @property
    def DOMAIN_KIND(self):  # noqa: D102 — kind-signature protocol slot
        return "replicated" if self.src.axis is None else "stacked"

    @property
    def CODOMAIN_KIND(self):  # noqa: D102 — kind-signature protocol slot
        return "replicated" if self.dst.axis is None else "stacked"

    def pieces(self) -> Tuple[LinearOp, ...]:
        """The constituent ops in MATRIX-PRODUCT order (last applied
        first), so ``Compose(self.pieces())`` is the equivalent chain."""
        s, d = self.src, self.dst
        if s == d:
            return (Identity(),)
        if s.axis is None:
            return (BatchScatter(d.axis, d.dim),)
        if d.axis is None:
            return (GradSumReduce(s.axis, s.dim),)
        if s.axis == d.axis:
            return (AllToAll(s.axis, d.dim, s.dim),)
        return (BatchScatter(d.axis, d.dim), GradSumReduce(s.axis, s.dim))

    def __call__(self, x):
        for op in reversed(self.pieces()):
            x = op(x)
        return x

    def _adjoint(self):
        # The adjoint of a re-layout is the reverse re-layout: each
        # piece's adjoint is the corresponding piece of the reverse path.
        return Repartition(self.dst, self.src)

    def space_map(self, space, axis_sizes):
        """Entry check against ``src``, then fold the pieces' signatures."""
        s = self.src
        if s.axis is None:
            if space.kind != "replicated":
                raise SpaceTypeError(
                    f"{self!r} repartitions from the replicated layout, got "
                    f"{space.describe()}")
        elif (space.kind != "stacked" or space.axis != s.axis
              or space.dim != s.dim):
            raise SpaceTypeError(
                f"{self!r} repartitions from {s.describe()}, got "
                f"{space.describe()}")
        for op in reversed(self.pieces()):
            space = op.space_map(space, axis_sizes)
        return space

    def in_spec(self, rank):
        s = self.src
        return P() if s.axis is None else _axis_at(s.axis, s.dim, rank)

    def out_spec(self, rank):
        d = self.dst
        return P() if d.axis is None else _axis_at(d.axis, d.dim, rank)


@dataclass(frozen=True)
class CapacityRestrict(LinearOp):
    """P_cap: restriction onto the first ``keep`` of ``total`` slots.

    The capacity-factor truncation of MoE dispatch (DESIGN §8) as a
    first-class operator instead of a silent mask: the forward DROPS the
    trailing ``total - keep`` entries along tensor ``dim`` (over-capacity
    slots), a restriction map F^total -> F^keep on that dim.  Its adjoint
    is the zero-padded embedding F^keep -> F^total (``embed=True``): kept
    slots return to their positions, dropped slots receive EXACTLY zero
    cotangent — the adjoint of a restriction is the inclusion, so dropped
    tokens vanish from the gradient by construction rather than by mask.

    Worker-local (no mesh axis): it composes junction-neutrally with the
    collectives and acts on replicated and stacked spaces alike, mapping
    the ``dim`` extent ``total -> keep`` (or ``keep -> total`` embedding).

    >>> CapacityRestrict(0, 6, 9).T == CapacityRestrict(0, 6, 9, embed=True)
    True
    >>> CapacityRestrict(0, 6, 9).T.T == CapacityRestrict(0, 6, 9)
    True
    """

    dim: int
    keep: int
    total: int
    embed: bool = False

    def __post_init__(self):
        if not 0 < self.keep <= self.total:
            raise SpaceTypeError(
                f"CapacityRestrict keeps {self.keep} of {self.total} slots — "
                f"need 0 < keep <= total")

    def __call__(self, x):
        if self.embed:
            shape = list(x.shape)
            shape[self.dim] = self.total - self.keep
            return torch.cat([x, x.new_zeros(shape)], dim=self.dim)
        return x.narrow(self.dim, 0, self.keep)

    def _adjoint(self):
        return CapacityRestrict(self.dim, self.keep, self.total,
                                not self.embed)

    def space_map(self, space, axis_sizes):
        """``dim`` extent ``total -> keep`` (restriction) or ``keep ->
        total`` (zero-padded embedding), on replicated or stacked spaces
        alike (worker-local: the stacking axis is untouched)."""
        _expect_dim(self, space, self.dim)
        want = self.keep if self.embed else self.total
        if space.local_shape[self.dim] != want:
            raise SpaceTypeError(
                f"{self!r} consumes extent {want} along dim {self.dim}, got "
                f"{space.describe()}")
        shape = list(space.local_shape)
        shape[self.dim] = self.total if self.embed else self.keep
        if space.kind == "replicated":
            return Space.replicated(shape)
        return Space.stacked(space.axis, space.dim, shape)

    def in_spec(self, rank):
        return P()

    def out_spec(self, rank):
        return P()


def _as_widths(w) -> Tuple[int, ...] | None:
    if w is None:
        return None
    if isinstance(w, int):
        raise TypeError("per-worker widths must be a sequence, got int")
    return tuple(int(v) for v in w)


def _check_halo_widths(op, k: int):
    """Unbalanced halos carry one width per worker: lengths must equal k."""
    for name in ("left_widths", "right_widths"):
        w = getattr(op, name)
        if w is not None and len(w) != k:
            raise SpaceTypeError(
                f"{op!r} carries {len(w)} per-worker {name} but axis "
                f"'{op.axis}' has {k} workers")


@dataclass(frozen=True)
class HaloExchange(LinearOp):
    """H (paper Eq. 10-12, App. B): attach neighbour margins along ``dim``.

    Balanced form: uniform ``left``/``right`` widths on every worker.
    Unbalanced form (App. B): pass per-worker ``left_widths`` /
    ``right_widths`` (from ``partition.compute_halos``); buffers are uniform
    at the max width and a per-worker diagonal mask zeroes unused lanes —
    masking is linear, so the composite stays adjoint-exact.

    Adjoint: ``HaloAccumulate`` — margins travel back to the owning
    neighbour and ADD into its bulk (the paper's key §3 observation).
    """

    axis: str
    dim: int = 0
    left: int = 0
    right: int = 0
    left_widths: Tuple[int, ...] | None = field(default=None)
    right_widths: Tuple[int, ...] | None = field(default=None)

    def __post_init__(self):
        object.__setattr__(self, "left_widths", _as_widths(self.left_widths))
        object.__setattr__(self, "right_widths", _as_widths(self.right_widths))
        if (self.left_widths is None) != (self.right_widths is None):
            raise ValueError("pass both left_widths and right_widths or neither")
        if self.left_widths is not None:
            object.__setattr__(self, "left", int(max(self.left_widths)))
            object.__setattr__(self, "right", int(max(self.right_widths)))

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    @property
    def unbalanced(self) -> bool:
        return self.left_widths is not None

    def __call__(self, x):
        if self.unbalanced:
            return prim.halo_exchange_unbalanced(
                x, self.axis, self.dim, self.left_widths, self.right_widths)
        return prim.halo_exchange(x, self.axis, self.dim, self.left, self.right)

    def _adjoint(self):
        return HaloAccumulate(self.axis, self.dim, self.left, self.right,
                              self.left_widths, self.right_widths)

    def space_map(self, space, axis_sizes):
        """Stacked at ``dim`` -> stacked at ``dim`` with margins attached."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.dim)
        _check_halo_widths(self, k)
        if space.local_shape[self.dim] < max(self.left, self.right):
            raise SpaceTypeError(
                f"{self!r} needs bulk >= max margin {max(self.left, self.right)}"
                f" along dim {self.dim}, got {space.describe()}")
        shape = list(space.local_shape)
        shape[self.dim] += self.left + self.right
        return Space.stacked(self.axis, self.dim, shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)


@dataclass(frozen=True)
class HaloAccumulate(LinearOp):
    """H* (paper Eq. 12): margins return to their owner and add into the
    bulk.  For the unbalanced form the diagonal mask is self-adjoint, so
    H_unbal* = H* ∘ mask."""

    axis: str
    dim: int = 0
    left: int = 0
    right: int = 0
    left_widths: Tuple[int, ...] | None = field(default=None)
    right_widths: Tuple[int, ...] | None = field(default=None)

    def __post_init__(self):
        # Mirror HaloExchange: buffer widths are the per-worker maxima, so a
        # directly constructed unbalanced accumulate behaves identically to
        # HaloExchange(widths).T and .T is an involution.
        object.__setattr__(self, "left_widths", _as_widths(self.left_widths))
        object.__setattr__(self, "right_widths", _as_widths(self.right_widths))
        if (self.left_widths is None) != (self.right_widths is None):
            raise ValueError("pass both left_widths and right_widths or neither")
        if self.left_widths is not None:
            object.__setattr__(self, "left", int(max(self.left_widths)))
            object.__setattr__(self, "right", int(max(self.right_widths)))

    DOMAIN_KIND = "stacked"
    CODOMAIN_KIND = "stacked"

    def __call__(self, y):
        if self.left_widths is not None:
            y = _unbalanced_mask(y, self.axis, self.dim, self.left_widths,
                                 self.right_widths)
        return prim.halo_accumulate(y, self.axis, self.dim, self.left, self.right)

    def _adjoint(self):
        return HaloExchange(self.axis, self.dim, self.left, self.right,
                            self.left_widths, self.right_widths)

    def space_map(self, space, axis_sizes):
        """Stacked at ``dim`` -> stacked at ``dim`` with margins folded back
        into the bulk (the remaining bulk must itself fit the margins, so
        the adjoint HaloExchange stays applicable — involution)."""
        k = _axis_size(self, axis_sizes)
        _expect_stacked(self, space, dim=self.dim)
        _check_halo_widths(self, k)
        bulk = space.local_shape[self.dim] - self.left - self.right
        if bulk < max(self.left, self.right, 1):
            raise SpaceTypeError(
                f"{self!r} would leave bulk {bulk} < max(margins, 1) along "
                f"dim {self.dim}, got {space.describe()}")
        shape = list(space.local_shape)
        shape[self.dim] = bulk
        return Space.stacked(self.axis, self.dim, shape)

    def in_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)

    def out_spec(self, rank):
        return _axis_at(self.axis, self.dim, rank)


def _unbalanced_mask(y, axis, dim, left_widths, right_widths):
    """The diagonal operator D of the unbalanced halo (paper App. B): keep
    worker i's [lmax - lw_i, lmax + bulk + rw_i) lanes, zero the rest."""
    return y * prim.halo_mask(y.shape, dim, prim.axis_index(axis),
                              left_widths, right_widths, y.device)


# ---------------------------------------------------------------------------
# Global lifts and the generic Eq. 13 harness.
# ---------------------------------------------------------------------------

def space_of(spec: P, global_shape, axis_sizes) -> Space:
    """The :class:`Space` a global array occupies under a boundary spec.

    ``P()``/all-None -> replicated; a single mesh axis at dim d -> stacked
    there (the global extent must divide by the axis size).  Multi-axis
    specs have no single-axis space reading and raise ``SpaceTypeError``.
    """
    entries = tuple(spec) + (None,) * (len(global_shape) - len(tuple(spec)))
    placed = [(d, a) for d, a in enumerate(entries) if a is not None]
    if not placed:
        return Space.replicated(global_shape)
    if len(placed) > 1 or not isinstance(placed[0][1], str):
        raise SpaceTypeError(
            f"spec {spec} shards more than one mesh axis: no single-axis "
            f"space reading")
    d, axis = placed[0]
    k = axis_sizes if isinstance(axis_sizes, int) else int(axis_sizes[axis])
    if global_shape[d] % k:
        raise SpaceTypeError(
            f"global dim {d} of shape {tuple(global_shape)} does not divide "
            f"by axis '{axis}' size {k}")
    local = list(global_shape)
    local[d] //= k
    return Space.stacked(axis, d, local)


def _placed(spec) -> list:
    """(dim, axis) for each split dim of ``spec``."""
    for axis in spec:
        if axis is not None and not isinstance(axis, str):
            raise ValueError(f"spec {spec}: one mesh axis per tensor dim")
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def spec_groups(spec, mesh) -> list:
    """The process groups a value under ``spec`` is stacked over: an inner
    product sums over these and counts the replicated axes once."""
    names = mesh.mesh_dim_names
    return [mesh.get_group(names.index(a)) for _, a in _placed(spec)]


def scatter(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's shard of a global array held the same on every rank:
    its block of each dim that ``spec`` splits (``shard_slice_replicated``,
    so autograd returns the global array's full gradient on every rank)."""
    with prim.use_mesh(mesh or prim.current_mesh()):
        for d, axis in _placed(spec):
            x = prim.shard_slice_replicated(x, axis, d)
    return x


def assemble(y: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The global array of the shards ``y`` laid out by ``spec``, on every
    rank (``all_gather_replicated``: its cotangent is the global one)."""
    with prim.use_mesh(mesh or prim.current_mesh()):
        for d, axis in reversed(_placed(spec)):
            y = prim.all_gather_replicated(y, axis, d)
    return y


def lift(op: LinearOp, mesh, rank: int):
    """Lift an op to a global operator F over its canonical boundary specs
    (the paper's inclusive-memory global view): scatter the global array
    to the ranks by ``op.in_spec``, apply the op on each rank, assemble by
    ``op.out_spec``.  F takes and returns arrays held the same on every
    rank, and autograd through it gives the global vector-Jacobian
    product."""
    in_spec, out_spec = op.in_spec(rank), op.out_spec(rank)

    def F(x):
        with prim.use_mesh(mesh):
            return assemble(op(scatter(x, in_spec)), out_spec)
    return F


def _global_shape(local_shape, spec, mesh) -> tuple:
    sizes = axis_sizes(mesh)
    shape = list(local_shape)
    for d, axis in _placed(spec):
        shape[d] *= sizes[axis]
    return tuple(shape)


def _randn(shape, generator, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def check_adjoint_pair(fwd, adj, mesh, in_spec, out_spec, shape, *,
                       generator=None, eps: float = 1e-4, name: str = "op",
                       x=None, y=None, dtype=torch.float32,
                       device=None) -> AdjointReport:
    """Paper Eq. 13 for a per-rank linear map ``fwd`` and its adjoint
    ``adj``, between the global spaces that ``in_spec`` and ``out_spec``
    lay out over ``mesh``: (a) <F x, y> = <x, adj y> and (b) autograd
    through ``fwd`` agrees with Eq. 13; the report carries the larger
    relative error.

    ``shape`` is the GLOBAL input shape.  ``x`` and ``y`` are the global
    input and cotangent (tensors or arrays, the same on every rank); each
    one not given is drawn from ``generator`` (seed 0 on ``device``), which
    every rank seeds alike.
    """
    device = torch.device(device or "cpu")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def as_global(a, shape_):
        if a is None:
            return _randn(shape_, generator, dtype, device)
        return torch.as_tensor(a, device=device)

    with prim.use_mesh(mesh):
        x = as_global(x, shape)
        x_loc = scatter(x, in_spec)
        with torch.no_grad():
            fx_loc = fwd(x_loc.clone())
        y = as_global(y, _global_shape(fx_loc.shape, out_spec, mesh))
        y_loc = scatter(y, out_spec)
        x_groups = spec_groups(in_spec, mesh)
        y_groups = spec_groups(out_spec, mesh)
        with torch.no_grad():
            rel_pair = rel_err(fx_loc, y_loc, x_loc, adj(y_loc.clone()),
                               x_groups, y_groups)
        rel_ad = adjoint_test(fwd, x_loc, y_loc, eps=eps, name=name,
                              x_groups=x_groups, y_groups=y_groups).rel_err
    return AdjointReport(name, max(rel_pair, rel_ad), eps)


def check_adjoint(op: LinearOp, mesh, shape, *, generator=None,
                  eps: float = 1e-4, name: str | None = None, x=None,
                  y=None, dtype=torch.float32, device=None) -> AdjointReport:
    """Paper Eq. 13 for ``op`` AND its registered adjoint ``op.T``.

    ``shape`` is the GLOBAL input shape under ``op.in_spec`` (sharded dims
    must divide by the mesh axis size).  Verifies both that ``op.T`` is the
    adjoint of ``op`` under the Euclidean inner product, and that autograd
    through the forward agrees (``check_adjoint_pair``); the returned report
    carries the max of the two relative errors.  When a COMPOSITE fails,
    the report's ``detail`` localizes the first failing constituent by
    position and its space signature (instead of a bare numeric mismatch).
    """
    if name is None:
        name = repr(op)
    rank = len(shape)
    report = check_adjoint_pair(op, op.T, mesh, op.in_spec(rank),
                                op.out_spec(rank), shape,
                                generator=generator, eps=eps, name=name,
                                x=x, y=y, dtype=dtype, device=device)
    if not report.passed and isinstance(op, Compose):
        report.detail = _localize_failure(op, mesh, shape, eps=eps,
                                          dtype=dtype, device=device)
    return report


def _localize_failure(op: Compose, mesh, shape, *, eps, dtype,
                      device) -> str:
    """Walk a failing composite's space trace, Eq.13-testing each
    constituent at its own global shape, and name the first failing
    position + space signature.  Every rank walks the same trace, so the
    collectives stay matched.  Best-effort: never masks the primary
    failure, so any diagnostic error degrades to an empty string."""
    try:
        sizes = axis_sizes(mesh)
        space = space_of(op.ops[-1].in_spec(len(shape)), shape, sizes)
        for i, o in enumerate(reversed(op.ops)):
            try:
                new = o.space_map(space, sizes)
            except SpaceTypeError as e:
                return (f"chain is ill-typed at position {i} "
                        f"(application order): {e}")
            sub = check_adjoint(o, mesh, space.global_shape(sizes), eps=eps,
                                dtype=dtype, device=device)
            if not sub.passed:
                return (f"first failing op: position {i} (application "
                        f"order) {o!r}, mapping {space.describe()} -> "
                        f"{new.describe()}; rel_err={sub.rel_err:.3g}")
            space = new
        return ("every constituent passes Eq. 13 individually; "
                "the failure is in the composition")
    except Exception:  # noqa: BLE001 — diagnostics must not mask the report
        return ""
