"""The port's static space typechecker (``repro_torch.analysis.spaces``;
DESIGN §7): every case of tests/test_spaces.py on the port's operators.

Pure shape algebra: no process group is touched.
Covers: every well-typed fuzzer chain passes ``typecheck``; the shared
registry reproduces the fuzzer's ORIGINAL hand-rolled move table exactly
(ground truth ported verbatim from the pre-PR-6 generator); every move the
generator refuses for TYPING reasons is rejected by ``typecheck`` with the
right diagnostic; known ill-typed composites (e.g. ``Broadcast`` after
``AllReduce``) fail at construction; the soundness/completeness boundary
(an Eq. 13-passing chain with no single consistent space reading is
rejected); and the ``dist_jit`` boundary guard.
"""

import random

import pytest

from repro_torch.analysis import spaces
from repro_torch.core import linop
from repro_torch.core.linop import Space, SpaceTypeError

AX = "tp"
MAX_DIM = 256


def _random_state(rng, k):
    """A random fuzzer start state (mirrors the generator's draw)."""
    rank = rng.randint(2, 3)
    if rng.randint(0, 1):
        sig = rng.randrange(rank)
        return Space.stacked(AX, sig, [rng.randint(1, 4) for _ in range(rank)])
    return Space.replicated([k * rng.randint(1, 2) for _ in range(rank)])


def _old_moves(k, space):
    """Hand-rolled ground-truth move table: the pre-PR-6 fuzzer's table,
    ported VERBATIM (sig None == replicated, else the stacked tensor dim),
    plus the PR-7 CapacityRestrict rows (replicated space only — the op
    typechecks everywhere, but its canonical boundary specs are replicated,
    so the generator only offers it where a lifted chain can start or end
    with it; embeds growth-capped) and the PR-10 Repartition rows (scatter
    in from replicated, gather out to replicated, dim move — legal exactly
    where their single-axis piece decompositions are)."""
    sig = None if space.kind == "replicated" else space.dim
    ls = list(space.local_shape)
    rank = len(ls)
    mv = [("identity", None)] if sig is None else []
    if sig is None:
        mv.append(("broadcast", None))
        for d in range(rank):
            if ls[d] % k == 0:
                mv.append(("batch_scatter", d))
        for d in range(rank):
            if ls[d] % k == 0:
                mv.append(("repartition_in", d))
    else:
        d = sig
        if d == 0:
            mv += [("sum_reduce", None), ("all_reduce", None),
                   ("send_recv", -2), ("send_recv", -1),
                   ("send_recv", 1), ("send_recv", 2),
                   ("kv_ring_shift", -2), ("kv_ring_shift", -1),
                   ("kv_ring_shift", 1), ("kv_ring_shift", 2)]
        if ls[d] * k <= MAX_DIM:
            mv += [("grad_sum_reduce", None), ("all_gather", None)]
        if ls[d] % k == 0:
            mv.append(("reduce_scatter", None))
        for s in range(rank):
            if s != d and ls[s] % k == 0 and ls[d] * k <= MAX_DIM:
                mv.append(("all_to_all", s))
        if ls[d] * k <= MAX_DIM:
            mv.append(("repartition_out", None))
        for s in range(rank):
            if s != d and ls[s] % k == 0 and ls[d] * k <= MAX_DIM:
                mv.append(("repartition_move", s))
        for left, right in ((0, 1), (1, 0), (1, 1), (2, 1), (2, 2)):
            if ls[d] >= max(left, right) and ls[d] + left + right <= MAX_DIM:
                mv.append(("halo", (left, right)))
            if ls[d] - left - right >= max(left, right, 1):
                mv.append(("halo_acc", (left, right)))
    if sig is None:
        for cd in range(rank):
            n = ls[cd]
            if n >= 2:
                for kp in sorted({n - 1, (n + 1) // 2}):
                    mv.append(("cap_restrict", (cd, kp)))
            for t in sorted({n + 1, 2 * n}):
                if t <= MAX_DIM:
                    mv.append(("cap_embed", (cd, t)))
    return mv


@pytest.mark.parametrize("k", [2, 4, 8])
def test_shared_registry_reproduces_the_old_generator(k):
    """legal_moves == the original hand-rolled table, over many random
    states AND along random walks (so drift in EITHER direction fails)."""
    rng = random.Random(k)
    for _ in range(200):
        space = _random_state(rng, k)
        for _ in range(rng.randint(1, 5)):
            new = spaces.legal_moves(AX, k, space, max_dim=MAX_DIM)
            old = _old_moves(k, space)
            assert set(new) == set(old), (space, set(new) ^ set(old))
            if not new:
                break
            _, space = spaces.apply_move(AX, k, space,
                                         rng.choice(sorted(new)))


@pytest.mark.parametrize("k", [2, 8])
def test_every_sampled_chain_typechecks(k):
    """Chains built move-by-move from the registry pass ``typecheck`` and
    the derived codomain matches the walk's final space."""
    rng = random.Random(k + 10)
    for _ in range(100):
        space0 = _random_state(rng, k)
        space, ops = space0, []
        for _ in range(rng.randint(1, 5)):
            mv = spaces.legal_moves(AX, k, space, max_dim=MAX_DIM)
            if not mv:
                break
            op, space = spaces.apply_move(AX, k, space,
                                          rng.choice(sorted(mv)))
            ops.append(op)
        chain = ops[0]
        for op in ops[1:]:
            chain = op @ chain
        trace = spaces.typecheck(chain, {AX: k}, space0)
        assert trace.out_space == space
        assert len(trace.steps) == len(ops)


@pytest.mark.parametrize("k", [2, 8])
def test_generator_negative_space_is_rejected(k):
    """Every move the generator REFUSES for typing reasons (refused by the
    old hand-rolled table and not merely by the growth cap) raises
    SpaceTypeError under ``typecheck`` — the static checker rejects
    exactly the composites the fuzzer refuses to sample."""
    rng = random.Random(k + 20)
    checked = 0
    for _ in range(200):
        space = _random_state(rng, k)
        legal = set(_old_moves(k, space))
        # The full universe: every move kind against this state.
        universe = set(spaces.candidate_moves(space))
        other = spaces.candidate_moves(
            Space.stacked(AX, 0, space.local_shape)
            if space.kind == "replicated"
            else Space.replicated(space.local_shape))
        universe |= set(other)
        for mv in sorted(universe - legal, key=repr):
            op = spaces.move_op(AX, space, mv)
            try:
                new = op.space_map(space, k)
            except SpaceTypeError:
                # Ill-typed: typecheck must reject it with a position diag.
                with pytest.raises(SpaceTypeError,
                                   match="position 0"):
                    spaces.typecheck(op, {AX: k}, space)
                checked += 1
                continue
            # Accepted by space_map but refused by the generator: must be a
            # growth-cap, identity-policy, or boundary-spec-policy refusal
            # (CapacityRestrict typechecks in stacked spaces but its
            # canonical lift specs are replicated), never a typing hole.
            assert (mv[0] == "identity"
                    or (mv[0] in ("cap_restrict", "cap_embed")
                        and space.kind != "replicated")
                    or max(new.local_shape) > MAX_DIM), (space, mv)
    assert checked > 100  # the negative space is genuinely exercised


def test_capacity_restrict_signature_on_ep():
    """CapacityRestrict typing: ``total -> keep`` on replicated AND stacked
    spaces (worker-local, stacking untouched); the adjoint is the
    zero-padded embedding ``keep -> total``; the MoE dispatch composes it
    with ``AllToAll`` on the dedicated ep axis (DESIGN §8)."""
    sz = {"ep": 4}
    cap = linop.CapacityRestrict(0, 8, 10)
    for sp in (Space.replicated((10, 3)), Space.stacked("ep", 1, (10, 3))):
        tr = spaces.typecheck(cap, sz, sp)
        assert tr.out_space.local_shape == (8, 3)
        assert tr.out_space.kind == sp.kind
    tr = spaces.typecheck(cap.T, sz, Space.stacked("ep", 1, (8, 3)))
    assert tr.out_space.local_shape == (10, 3)
    # dispatch: restrict onto the E*cap capacity slots, then repartition
    # token-slot-major -> expert-major over ep.
    dispatch = linop.AllToAll("ep", 0, 1) @ linop.CapacityRestrict(0, 8, 9)
    tr = spaces.typecheck(dispatch, sz, Space.stacked("ep", 1, (9, 5)))
    assert tr.out_space == Space.stacked("ep", 0, (2, 20))


def test_repartition_signature_and_negatives():
    """Repartition typing (DESIGN §10): src layout must match the incoming
    space EXACTLY (axis and dim); the codomain is the dst layout's space;
    the adjoint is the reverse repartition; mismatches are targeted
    SpaceTypeErrors."""
    sz = {AX: 4, "data": 2}
    a, b = linop.Layout(AX, 0), linop.Layout(AX, 1)
    rep = linop.Layout(None)
    # scatter in: replicated -> stacked, dim 0 split 4-ways
    tr = spaces.typecheck(linop.Repartition(rep, a), {AX: 4},
                          Space.replicated((8, 6)))
    assert tr.out_space == Space.stacked(AX, 0, (2, 6))
    # dim move: stacked dim 0 -> dim 1 (the AllToAll piece)
    tr = spaces.typecheck(linop.Repartition(a, b), {AX: 4},
                          Space.stacked(AX, 0, (2, 8)))
    assert tr.out_space == Space.stacked(AX, 1, (8, 2))
    # gather out: stacked -> replicated (global extent restored)
    tr = spaces.typecheck(linop.Repartition(b, rep), {AX: 4},
                          Space.stacked(AX, 1, (8, 2)))
    assert tr.out_space == Space.replicated((8, 8))
    # adjoint = reverse repartition, and it round-trips the signature
    assert linop.Repartition(a, b).T == linop.Repartition(b, a)
    back = linop.Repartition(a, b).T.space_map(
        Space.stacked(AX, 1, (8, 2)), {AX: 4})
    assert back == Space.stacked(AX, 0, (2, 8))
    # cross-axis (elastic reshard): data-stacked -> model-stacked
    tr = spaces.typecheck(
        linop.Repartition(linop.Layout("data", 0), linop.Layout(AX, 1)),
        sz, Space.stacked("data", 0, (4, 8)))
    assert tr.out_space == Space.stacked(AX, 1, (8, 2))
    # negatives: wrong source kind, wrong source dim, indivisible scatter
    with pytest.raises(SpaceTypeError):
        spaces.typecheck(linop.Repartition(a, rep), {AX: 4},
                         Space.replicated((8, 6)))
    with pytest.raises(SpaceTypeError):
        spaces.typecheck(linop.Repartition(a, rep), {AX: 4},
                         Space.stacked(AX, 1, (8, 2)))
    with pytest.raises(SpaceTypeError):
        spaces.typecheck(linop.Repartition(rep, a), {AX: 4},
                         Space.replicated((5, 6)))


def test_dispatch_after_combine_junction_rejected():
    """Ill-typed dispatch-after-combine: the combine's codomain is the
    RESTRICTED slot space (E*cap slots), so a dispatch expecting the padded
    scatter buffer (E*cap+1 slots, dropped tail included) cannot follow it
    — the static checker pins the off-by-capacity junction."""
    combine = linop.AllToAll("ep", 1, 0)
    redispatch = linop.AllToAll("ep", 0, 1) @ linop.CapacityRestrict(0, 8, 9)
    with pytest.raises(SpaceTypeError, match="position 1"):
        spaces.typecheck(redispatch @ combine, {"ep": 4},
                         Space.stacked("ep", 0, (2, 8)))


def test_known_ill_typed_composites_rejected_at_construction():
    """Kind-mismatched same-axis junctions die at ``@`` with a targeted
    diagnostic — before any trace or compile."""
    with pytest.raises(SpaceTypeError, match="consumes the replicated"):
        linop.Broadcast(AX) @ linop.AllReduce(AX)
    with pytest.raises(SpaceTypeError, match="consumes the stacked"):
        linop.SumReduce(AX) @ linop.SumReduce(AX)
    with pytest.raises(SpaceTypeError, match="replicated"):
        linop.Broadcast(AX) @ linop.AllGather(AX, 0)
    # Cross-axis junctions are NOT structurally decidable: allowed here.
    linop.Broadcast("a") @ linop.AllReduce("b")
    # The same composite nested inside Compose trees is still caught.
    good = linop.SendRecv(AX, 1) @ linop.AllReduce(AX)
    with pytest.raises(SpaceTypeError):
        linop.Broadcast(AX) @ good


def test_typecheck_diagnostics_name_position_and_spaces():
    """The failure message carries the application-order position, the op,
    and expected-vs-actual space."""
    chain = linop.ReduceScatter(AX, 0) @ linop.KVRingShift(AX, 1)
    with pytest.raises(SpaceTypeError) as ei:
        spaces.typecheck(chain, {AX: 8}, Space.stacked(AX, 0, (5, 3)))
    msg = str(ei.value)
    assert "position 1" in msg and "ReduceScatter" in msg
    assert "not divisible" in msg
    assert "derivation so far" in msg


def test_eq13_passing_chain_without_space_reading_is_rejected():
    """``AllGather(AX, 1) @ KVRingShift(AX, 1)`` passes Eq. 13 under its
    per-op boundary specs (tests/md/test_linop.py history) but its adjacent
    specs disagree about WHICH space the intermediate vector lives in —
    the typechecker is sound, not complete, and rejects it."""
    chain = linop.AllGather(AX, 1) @ linop.KVRingShift(AX, 1)
    with pytest.raises(SpaceTypeError, match="dim 1"):
        spaces.typecheck(chain, {AX: 8}, Space.stacked(AX, 0, (2, 4)))


def test_adjoint_swaps_signature_and_reversal_law():
    """``typecheck`` verifies .T maps the codomain back to the domain and
    the §2 reversal law — over the exported composite suite."""
    for name, op, sizes, space in spaces.exported_composites():
        trace = spaces.typecheck(op, sizes, space)
        back = op.T.space_map(trace.out_space, spaces.axis_sizes(sizes))
        assert back == space, name


def test_space_of_and_global_shape():
    """Boundary-spec -> Space interpretation round-trips global shapes."""
    from repro_torch.core.linop import PartitionSpec as P
    s = linop.space_of(P(None, AX), (3, 16), {AX: 8})
    assert s == Space.stacked(AX, 1, (3, 2))
    assert s.global_shape({AX: 8}) == (3, 16)
    assert linop.space_of(P(), (3, 16), {AX: 8}) == Space.replicated((3, 16))
    with pytest.raises(SpaceTypeError, match="not divide"):
        linop.space_of(P(AX), (5, 3), {AX: 8})
    with pytest.raises(SpaceTypeError, match="more than one"):
        linop.space_of(P("a", "b"), (8, 8), {"a": 2, "b": 2})


class _Mesh:
    """A one-axis ("data",) mesh shape: the boundary check reads names
    only, before anything runs."""

    mesh_dim_names = ("data",)

    def size(self, i):
        return 2


def test_dist_jit_rejects_malformed_boundary_specs():
    """Ill-typed dist_jit boundaries fail BEFORE anything runs."""
    from repro_torch.core.compile import dist_jit
    from repro_torch.core.linop import PartitionSpec as P
    from repro_torch.sharding import Policy

    pol = Policy(mesh=_Mesh())
    with pytest.raises(SpaceTypeError, match="names mesh axis"):
        dist_jit(lambda x: x, pol, (P("model"),), P())
    with pytest.raises(SpaceTypeError, match="two tensor dims"):
        dist_jit(lambda x: x, pol, (P("data", "data"),), P())


def test_typed_ops_registry_covers_every_linop():
    """Every concrete LinearOp subclass of the port's core appears in
    TYPED_OPS and its space_map is callable."""
    import inspect

    from repro_torch.core import linop as L
    from repro_torch.core import pipeline
    concrete = {obj.__name__ for mod in (L, pipeline)
                for _, obj in inspect.getmembers(mod)
                if inspect.isclass(obj) and issubclass(obj, L.LinearOp)
                and obj is not L.LinearOp}
    registered = {cls.__name__ for cls in spaces.TYPED_OPS}
    assert concrete <= registered, concrete - registered
    for cls in spaces.TYPED_OPS:
        assert callable(getattr(cls, "space_map"))


def test_cli_typechecks_the_exported_composites(capsys):
    """``python -m repro_torch.analysis.spaces``: every exported composite
    typechecks, every known negative is rejected; ``axis_sizes`` takes an
    int, a mapping or a mesh."""
    assert spaces.main() == 0
    out = capsys.readouterr().out
    assert "spaces: 11 composites typecheck, 10 negatives rejected" in out
    assert "ok   pipe_boundary" in out
    assert spaces.axis_sizes(4) == 4
    assert spaces.axis_sizes({"model": 2}) == {"model": 2}
    assert spaces.axis_sizes(_Mesh()) == {"data": 2}
