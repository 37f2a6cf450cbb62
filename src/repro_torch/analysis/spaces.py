"""Static space type-checker for the operator algebra (mirrors
``repro/analysis/spaces.py``; DESIGN §7).

The paper's operators are maps between SPECIFIC global vector spaces —
replicated F^n vs k-worker-stacked F^{kn} (§2) — and Eq. 13 only makes
sense for a composite whose adjacent domains/codomains agree.  The repo
enforced this dynamically (Eq. 13 on live devices) with the space
signatures living only inside the property fuzzer's chain generator; this
module makes the typing judgment STATIC:

- ``typecheck(op, mesh, in_space)`` walks a composite's ``space_map``
  signatures (declared per-op in ``core/linop.py``) with full shard-shape
  accuracy, raising :class:`~repro_torch.core.linop.SpaceTypeError` with the
  failing position and the expected-vs-actual space, and verifies
  structurally that ``.T`` swaps domain and codomain and that the reversal
  law ``(A@B).T == B.T@A.T`` holds;
- ``legal_moves``/``apply_move`` are the ONE shared registry of "which op
  applies in which space" that the adjoint-property fuzzer samples from
  (it previously hand-rolled the same table);
- ``python -m repro_torch.analysis.spaces`` typechecks the exported
  composites and asserts known ill-typed ones are rejected.

No device or process group is touched: the judgment is pure shape algebra
over the port's ``core/linop.py`` signatures (the same as the
reference's), and the port's fuzzer (tests/test_torch_linop.py) draws its
chains from this registry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core import linop, pipeline
from repro_torch.core.linop import Compose, LinearOp, Space, SpaceTypeError

__all__ = [
    "Space",
    "SpaceTypeError",
    "SpaceStep",
    "SpaceTrace",
    "typecheck",
    "axis_sizes",
    "TYPED_OPS",
    "candidate_moves",
    "legal_moves",
    "apply_move",
    "move_op",
]

# Every concrete LinearOp with a declared space signature (tests check that
# each subclass in core/linop.py appears here).  StageBoundary inherits
# SendRecv's signature; Compose folds its constituents'.
TYPED_OPS = (
    linop.Identity,
    linop.Broadcast,
    linop.SumReduce,
    linop.AllReduce,
    linop.AllGather,
    linop.ReduceScatter,
    linop.AllToAll,
    linop.SendRecv,
    linop.KVRingShift,
    linop.BatchScatter,
    linop.GradSumReduce,
    linop.Repartition,
    linop.CapacityRestrict,
    linop.HaloExchange,
    linop.HaloAccumulate,
    linop.Compose,
    pipeline.StageBoundary,
)


def axis_sizes(mesh) -> dict:
    """Normalize a ``DeviceMesh`` / ``{axis: size}`` mapping / int into
    what ``LinearOp.space_map`` consumes."""
    if isinstance(mesh, int):
        return mesh
    if hasattr(mesh, "mesh_dim_names"):
        return linop.axis_sizes(mesh)
    return {a: int(s) for a, s in dict(mesh).items()}


@dataclass(frozen=True)
class SpaceStep:
    """One application step of a typechecked chain: op, domain, codomain."""

    position: int
    op: LinearOp
    domain: Space
    codomain: Space


@dataclass(frozen=True)
class SpaceTrace:
    """A successful typing derivation: per-op steps plus the end spaces."""

    steps: Tuple[SpaceStep, ...]
    in_space: Space
    out_space: Space

    def describe(self) -> str:
        """Multi-line rendering of the derivation (for diagnostics/docs)."""
        lines = [f"  in : {self.in_space.describe()}"]
        for s in self.steps:
            lines.append(f"  {s.position:2d} : {s.op!r} -> "
                         f"{s.codomain.describe()}")
        return "\n".join(lines)


def typecheck(op: LinearOp, mesh, in_space: Space) -> SpaceTrace:
    """The DESIGN §7 typing judgment for ``op`` applied to ``in_space``.

    Validates every junction of a composite with shard-shape accuracy
    (positions are in APPLICATION order), then verifies structurally that
    the registered adjoint swaps the signature — ``op.T`` maps the
    derived codomain back to ``in_space`` — and that the §2 reversal law
    ``(A@B).T == B.T@A.T`` holds.  Returns the full derivation; raises
    :class:`SpaceTypeError` with the failing position otherwise.
    """
    sizes = axis_sizes(mesh)
    ops = op.ops if isinstance(op, Compose) else (op,)
    steps = []
    space = in_space
    for i, o in enumerate(reversed(ops)):
        try:
            new = o.space_map(space, sizes)
        except SpaceTypeError as e:
            raise SpaceTypeError(
                f"ill-typed composite at position {i} (application order), "
                f"{o!r}: {e}\n  derivation so far:\n"
                + SpaceTrace(tuple(steps), in_space, space).describe()
            ) from None
        steps.append(SpaceStep(i, o, space, new))
        space = new
    # The adjoint must swap the signature: op.T maps codomain -> domain.
    try:
        back = op.T.space_map(space, sizes)
    except SpaceTypeError as e:
        raise SpaceTypeError(
            f"adjoint {op.T!r} does not accept the codomain "
            f"{space.describe()}: {e}") from None
    if back != in_space:
        raise SpaceTypeError(
            f"adjoint does not swap the signature: {op.T!r} maps "
            f"{space.describe()} to {back.describe()}, expected "
            f"{in_space.describe()}")
    # §2 reversal law / involution, structurally.
    if isinstance(op, Compose):
        want = Compose(tuple(o.T for o in reversed(op.ops)))
        if op.T != want:
            raise SpaceTypeError(
                f"reversal law violated: {op.T!r} != {want!r}")
    if op.T.T != op:
        raise SpaceTypeError(f"adjoint is not an involution for {op!r}")
    return SpaceTrace(tuple(steps), in_space, space)


# ---------------------------------------------------------------------------
# The shared move registry (what the property fuzzer samples).
# ---------------------------------------------------------------------------

_OFFSETS = (-2, -1, 1, 2)
_HALO_WIDTHS = ((0, 1), (1, 0), (1, 1), (2, 1), (2, 2))


def candidate_moves(space: Space) -> list:
    """Every move the chain generator could CONSIDER in ``space`` (before
    legality filtering): ``(kind, arg)`` pairs, hashable and deterministic."""
    rank = len(space.local_shape)
    # CapacityRestrict (the MoE capacity truncation, DESIGN §8) typechecks
    # in EVERY space — it is worker-local and kind-agnostic — but its
    # CANONICAL boundary specs (in_spec/out_spec) are replicated, and the
    # fuzzer lifts each sampled chain through its boundary ops' canonical
    # specs.  So the generator only OFFERS it in replicated space; stacked
    # mid-chain placements are covered by the exported composites below and
    # the hand-built chains in tests/md/test_linop.py.
    cap = []
    for cd, n in enumerate(space.local_shape):
        if n >= 2:
            cap += [("cap_restrict", (cd, kp))
                    for kp in sorted({n - 1, (n + 1) // 2})]
        cap += [("cap_embed", (cd, t)) for t in sorted({n + 1, 2 * n})]
    if space.kind == "replicated":
        mv = [("identity", None), ("broadcast", None)]
        mv += [("batch_scatter", d) for d in range(rank)]
        mv += [("repartition_in", d) for d in range(rank)]
        return mv + cap
    d = space.dim
    mv = []
    if d == 0:
        mv += [("sum_reduce", None), ("all_reduce", None)]
        mv += [("send_recv", o) for o in _OFFSETS]
        mv += [("kv_ring_shift", o) for o in _OFFSETS]
    mv += [("grad_sum_reduce", None), ("all_gather", None),
           ("reduce_scatter", None)]
    mv += [("all_to_all", s) for s in range(rank) if s != d]
    mv += [("repartition_out", None)]
    mv += [("repartition_move", s) for s in range(rank) if s != d]
    mv += [("halo", w) for w in _HALO_WIDTHS]
    mv += [("halo_acc", w) for w in _HALO_WIDTHS]
    return mv


def move_op(axis: str, space: Space, move) -> LinearOp:
    """Construct the LinearOp a move denotes (independent of legality)."""
    kind, arg = move
    d = space.dim if space.dim is not None else 0
    if kind == "identity":
        return linop.Identity()
    if kind == "broadcast":
        return linop.Broadcast(axis)
    if kind == "batch_scatter":
        return linop.BatchScatter(axis, arg)
    if kind == "sum_reduce":
        return linop.SumReduce(axis)
    if kind == "all_reduce":
        return linop.AllReduce(axis)
    if kind == "send_recv":
        return linop.SendRecv(axis, arg)
    if kind == "kv_ring_shift":
        return linop.KVRingShift(axis, arg)
    if kind == "grad_sum_reduce":
        return linop.GradSumReduce(axis, d)
    if kind == "all_gather":
        return linop.AllGather(axis, d)
    if kind == "reduce_scatter":
        return linop.ReduceScatter(axis, d)
    if kind == "all_to_all":
        return linop.AllToAll(axis, arg, d)
    if kind == "halo":
        return linop.HaloExchange(axis, d, *arg)
    if kind == "halo_acc":
        return linop.HaloAccumulate(axis, d, *arg)
    if kind == "repartition_in":
        return linop.Repartition(linop.Layout(None), linop.Layout(axis, arg))
    if kind == "repartition_out":
        return linop.Repartition(linop.Layout(axis, d), linop.Layout(None))
    if kind == "repartition_move":
        return linop.Repartition(linop.Layout(axis, d), linop.Layout(axis, arg))
    if kind == "cap_restrict":
        cd, keep = arg
        return linop.CapacityRestrict(cd, keep, space.local_shape[cd])
    if kind == "cap_embed":
        cd, total = arg
        return linop.CapacityRestrict(cd, space.local_shape[cd], total,
                                      embed=True)
    raise AssertionError(f"unknown move kind {kind!r}")


def legal_moves(axis: str, k: int, space: Space, *,
                max_dim: int = 256) -> list:
    """Moves whose op ACCEPTS ``space`` (per ``space_map``) and whose
    result keeps every local extent within ``max_dim`` — exactly the
    positive set the adjoint-property fuzzer samples."""
    out = []
    for mv in candidate_moves(space):
        op = move_op(axis, space, mv)
        try:
            new = op.space_map(space, k)
        except SpaceTypeError:
            continue
        if new.local_shape and max(new.local_shape) > max_dim:
            continue
        out.append(mv)
    return out


def apply_move(axis: str, k: int, space: Space, move):
    """Materialize a move: ``(op, codomain Space)`` via the op's own
    ``space_map`` — the single source of truth for the transform."""
    op = move_op(axis, space, move)
    return op, op.space_map(space, k)


# ---------------------------------------------------------------------------
# CLI: typecheck the exported composites.
# ---------------------------------------------------------------------------

def exported_composites() -> list:
    """(name, op, axis_sizes, in_space) for the canonical composite
    programs: the reference's list (tests/md/test_linop.py COMPOSITES
    plus the pipeline boundary), over the port's operators."""
    AX, sz = "model", {"model": 8, "data": 8, "ctx": 4, "pipe": 4, "ep": 2}
    St, Re = Space.stacked, Space.replicated
    return [
        ("issue_chain",
         linop.HaloExchange(AX, 0, 1, 1) @ linop.SendRecv(AX, 1)
         @ linop.AllGather(AX, 0), sz, St(AX, 0, (2, 3))),
        ("allreduce_factored",
         linop.Broadcast(AX) @ linop.SumReduce(AX), sz, St(AX, 0, (16, 3))),
        ("partitioned_roundtrip",
         linop.ReduceScatter(AX, 0) @ linop.SendRecv(AX, -1)
         @ linop.AllGather(AX, 0), sz, St(AX, 0, (2, 3))),
        ("halo_spsd",
         linop.HaloExchange(AX, 0, 2, 1).T @ linop.HaloExchange(AX, 0, 2, 1),
         sz, St(AX, 0, (4, 3))),
        ("dp_roundtrip",
         linop.GradSumReduce("data", 1) @ linop.BatchScatter("data", 1),
         sz, Re((4, 16))),
        ("ring_roundtrip",
         linop.KVRingShift("ctx", -1) @ linop.KVRingShift("ctx", 1),
         sz, St("ctx", 0, (4, 3))),
        ("ring_then_gather",
         linop.AllGather("ctx", 0) @ linop.KVRingShift("ctx", 1),
         sz, St("ctx", 0, (4, 4))),
        ("alltoall_swap",
         linop.AllToAll(AX, 0, 1).T @ linop.AllToAll(AX, 0, 1),
         sz, St(AX, 1, (8, 8))),
        ("moe_dispatch_combine",
         linop.AllToAll("ep", 0, 1).T @ linop.AllToAll("ep", 0, 1)
         @ linop.CapacityRestrict(0, 8, 9),
         sz, St("ep", 1, (9, 4))),
        ("pipe_boundary",
         pipeline.StageBoundary("pipe", -1) @ pipeline.StageBoundary("pipe", 1),
         sz, St("pipe", 0, (4, 3))),
        # The elastic reshard path: a dp-sharded leaf re-homed onto the
        # model axis and back (the reference's checkpoint/ckpt.py::
        # restore_resharded): cross-axis repartition through the replicated
        # space, the reverse repartition restoring the source layout.
        ("elastic_reshard_roundtrip",
         linop.Repartition(linop.Layout("model", 1), linop.Layout("data", 0))
         @ linop.Repartition(linop.Layout("data", 0),
                             linop.Layout("model", 1)),
         sz, St("data", 0, (2, 16))),
    ]


def _expect_reject(name, build, mesh, in_space=None):
    """Assert a known-ill-typed composite raises SpaceTypeError (either at
    construction or under ``typecheck``); returns the diagnostic."""
    try:
        op = build()
        if in_space is not None:
            typecheck(op, mesh, in_space)
    except SpaceTypeError as e:
        return str(e)
    raise AssertionError(f"ill-typed composite {name!r} was accepted")


def main() -> int:
    """Typecheck every exported composite; reject the known-negative set."""
    sz = {"model": 8, "data": 8, "ctx": 4, "pipe": 4, "ep": 2}
    for name, op, sizes, space in exported_composites():
        trace = typecheck(op, sizes, space)
        print(f"ok   {name}: {trace.in_space.describe()} |- "
              f"{trace.out_space.describe()}")
    negatives = [
        ("broadcast_after_allreduce",
         lambda: linop.Broadcast("model") @ linop.AllReduce("model"),
         sz, None),
        ("double_sum_reduce",
         lambda: linop.SumReduce("model") @ linop.SumReduce("model"),
         sz, None),
        ("rs_not_divisible",
         lambda: linop.ReduceScatter("model", 0),
         sz, Space.stacked("model", 0, (5, 3))),
        ("gather_dim_mismatch",
         lambda: linop.AllGather("model", 1) @ linop.KVRingShift("model", 1),
         sz, Space.stacked("model", 0, (2, 4))),
        ("axis_not_in_mesh",
         lambda: linop.AllGather("tp9", 0),
         sz, Space.stacked("tp9", 0, (2, 4))),
        ("wrong_axis_stacking",
         lambda: linop.AllReduce("model"),
         sz, Space.stacked("ctx", 0, (4, 3))),
        ("cap_restrict_after_combine",
         # combine hands back E*cap kept slots; restricting as if the
         # dropped tail were still present is the classic off-by-capacity
         lambda: linop.CapacityRestrict(0, 8, 9) @ linop.AllToAll("ep", 1, 0),
         sz, Space.stacked("ep", 0, (4, 8))),
        ("cap_keep_out_of_range",
         lambda: linop.CapacityRestrict(0, 7, 6),
         sz, None),
        ("repartition_wrong_source_layout",
         # the value is stacked over 'ctx' but the plan claims it starts
         # replicated — the mistake restore_resharded's manifest check
         # exists to catch
         lambda: linop.Repartition(linop.Layout(None),
                                   linop.Layout("model", 0)),
         sz, Space.stacked("ctx", 0, (4, 3))),
        ("repartition_dim_mismatch",
         lambda: linop.Repartition(linop.Layout("model", 1),
                                   linop.Layout("data", 0)),
         sz, Space.stacked("model", 0, (2, 4))),
    ]
    for name, build, sizes, space in negatives:
        diag = _expect_reject(name, build, sizes, space)
        print(f"ok   rejected {name}: {diag.splitlines()[0][:100]}")
    print(f"spaces: {len(exported_composites())} composites typecheck, "
          f"{len(negatives)} negatives rejected")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
