"""The port's operator algebra (``repro_torch/core/linop.py``) against the
JAX package's, on 8 gloo ranks.

Mirrors tests/md/test_linop.py (every concrete op and its adjoint, the
composites, the reversal law, the cross-axis repartition, the random
chains, the App. B unbalanced halo) and tests/md/test_adjoint_property.py
(random space-typed chains over 1-D to 5-D meshes, drawn with the port's
own move registry ``repro_torch.analysis.spaces``, which offers the same
moves as the reference's ``repro.analysis.spaces``, and the DP pair).
One pool of 8 gloo ranks runs the port's side while a child interpreter
with 8 host devices runs the JAX side on the same numpy draws.

Each op holds: Eq. 13, both (a) <Fx, y> = <x, op.T y> and (b) autograd
through the hand-written backwards, at the reference's pin 1e-4, on both
sides; the assembled global forward equal to JAX's (bitwise for pure data
movement, 1e-6 relative where a sum's order may differ); the global
vector-Jacobian product within 1e-5.
"""

import doctest
import functools
import json
import random

import numpy as np
import pytest
import torch

import torch_dist_cases as C
from repro_torch.core import linop, partition
from repro_torch.core.linop import SpaceTypeError, check_adjoint
from repro_torch.launch import mesh as tmesh

POOL_TIMEOUT_S = 600
N_FUZZ = 60          # tests/md/test_adjoint_property.py:N_EXAMPLES
MAX_DIM = 256
CASES = C.linop_cases(linop, partition.compute_halos)
OP_SWEEP = C.op_sweep(linop)
SUMS = (linop.SumReduce, linop.AllReduce, linop.ReduceScatter,
        linop.HaloAccumulate)


def _has_sum(op) -> bool:
    """Whether the forward adds values (so its order may differ)."""
    ops = op.ops if isinstance(op, linop.Compose) else (op,)
    return any(isinstance(o, SUMS) for o in ops)


def _eval_op(cid, op, m, shape, out, adjoint=True):
    """Eq. 13 (a) and (b) on the local shards, and the lifted global
    forward and vjp, for ``op`` and (unless told not to) ``op.T``."""
    seed = C.seed_of(cid)
    x = torch.from_numpy(C.draw(shape, seed))
    F = linop.lift(op, m, len(shape))
    with torch.no_grad():
        fx = F(x)
    y = torch.from_numpy(C.draw(tuple(fx.shape), seed + 1))
    report = check_adjoint(op, m, shape, x=x, y=y)
    xg = x.clone().requires_grad_()
    (vjp,) = torch.autograd.grad(F(xg), xg, y)
    out[cid] = {"fx": fx, "vjp": vjp, "rel": report.rel_err,
                "detail": report.detail}
    if adjoint:
        _eval_op(cid + ".T", op.T, m, tuple(fx.shape), out, adjoint=False)


def _rank_fn(chains, rank, mesh1d):
    meshes = {"1d": mesh1d}
    for name, (shape, axes) in C.MESHES.items():
        if name != "1d":
            meshes[name] = tmesh.make_host_mesh(shape, axes, device="cpu")
    out = {}
    for cid, (mname, op, shape) in CASES.items():
        _eval_op(cid, op, meshes[mname], shape, out)
    for i, chain in enumerate(chains):
        op = C.chain_of(linop, chain["ops"])
        _eval_op(f"fuzz{i}", op, meshes[chain["mesh"]],
                 tuple(chain["shape"]), out, adjoint=False)
    for cid, (mname, op, shape) in OP_SWEEP.items():
        m = meshes[mname]
        sizes = linop.axis_sizes(m)
        out_shape = op.space_map(linop.space_of(
            op.in_spec(len(shape)), shape, sizes), sizes).global_shape(sizes)
        out["sweep " + cid] = (check_adjoint(op, m, shape).rel_err,
                               check_adjoint(op.T, m, out_shape).rel_err)
    return out


def _fuzz_chains(n: int, seed: int = 0) -> list:
    """Space-typed random chains drawn as the reference's fuzzer draws them
    (tests/md/test_adjoint_property.py:_draw_chain), from the port's move
    registry ``repro_torch.analysis.spaces``, each checked by its
    ``typecheck``."""
    from repro_torch.analysis import spaces
    from repro_torch.core.linop import Space
    rng = random.Random(seed)
    chains = []
    for _ in range(n):
        mname, ax = rng.choice(C.FUZZ_CHOICES)
        shape, axes = C.MESHES[mname]
        k = dict(zip(axes, shape))[ax]
        rank = rng.randint(2, 3)
        if rng.randint(0, 1):
            sig = rng.randint(0, rank - 1)
            space = Space.stacked(ax, sig,
                                  [rng.randint(1, 4) for _ in range(rank)])
        else:
            space = Space.replicated(
                [k * rng.randint(1, 2) for _ in range(rank)])
        space0, ops = space, []
        for _ in range(rng.randint(1, 5)):
            moves = spaces.legal_moves(ax, k, space, max_dim=MAX_DIM)
            if not moves:
                break
            op, space = spaces.apply_move(ax, k, space, rng.choice(moves))
            ops.append(op)
        chain = ops[0]
        for op in ops[1:]:
            chain = op @ chain
        spaces.typecheck(chain, {ax: k}, space0)
        chains.append({"mesh": mname, "axis": ax, "k": k,
                       "ops": [C.describe(o) for o in ops],
                       "shape": list(space0.global_shape(k))})
    return chains


@pytest.fixture(scope="module")
def chains():
    return _fuzz_chains(N_FUZZ)


@pytest.fixture(scope="module")
def results(tmp_path_factory, chains):
    tmp = tmp_path_factory.mktemp("jax")
    (tmp / "chains.json").write_text(json.dumps(chains))
    child = C.start_jax("linop", tmp / "linop.npz", tmp / "chains.json")
    try:
        ranks = tmesh.spawn(functools.partial(_rank_fn, chains), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = C.finish_jax(child, tmp / "linop.npz")
    return ranks, jax_out


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _parity(results, cid, op):
    ranks, jax_out = results
    port = ranks[0][cid]
    assert port["rel"] < C.EPS, (cid, port["rel"], port["detail"])
    assert jax_out[f"{cid}/rel"] < C.EPS, (cid, "jax")
    for r, other in enumerate(ranks[1:], 1):
        for key in ("fx", "vjp"):
            np.testing.assert_array_equal(other[cid][key], port[key],
                                          err_msg=f"{cid} rank {r} {key}")
    want = jax_out[f"{cid}/fx"]
    if _has_sum(op):
        _close(port["fx"], want, C.FWD_RTOL, cid)
    else:
        np.testing.assert_array_equal(port["fx"], want, err_msg=cid)
    _close(port["vjp"], jax_out[f"{cid}/vjp"], C.GRAD_TOL, cid)


OP_IDS = [cid for cid in CASES if cid.startswith("op:")]


@pytest.mark.parametrize("cid", OP_IDS, ids=[c[3:] for c in OP_IDS])
def test_every_concrete_op_passes_eq13(results, cid):
    _parity(results, cid, CASES[cid][1])


@pytest.mark.parametrize("cid", OP_IDS, ids=[c[3:] for c in OP_IDS])
def test_every_adjoint_op_passes_eq13(results, cid):
    _parity(results, cid + ".T", CASES[cid][1].T)


CHAIN_IDS = [cid for cid in CASES if cid.startswith("chain")]


@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_composites_pass_eq13(results, cid):
    _parity(results, cid, CASES[cid][1])
    _parity(results, cid + ".T", CASES[cid][1].T)


def test_reversal_law_structural():
    AX = C.AX
    A = linop.HaloExchange(AX, 0, 1, 1)
    B = linop.SendRecv(AX, 1)
    Cg = linop.AllGather(AX, 0)
    assert (A @ B @ Cg).T == Cg.T @ B.T @ A.T
    assert (A @ B).T == B.T @ A.T
    assert (A @ B).T.T == A @ B
    assert linop.AllGather(AX, 2).T == linop.ReduceScatter(AX, 2)
    assert linop.SumReduce(AX).T == linop.Broadcast(AX)
    assert linop.AllToAll(AX, 1, 0).T == linop.AllToAll(AX, 0, 1)
    assert linop.SendRecv(AX, 3).T == linop.SendRecv(AX, -3)
    assert linop.AllReduce(AX).T == linop.AllReduce(AX)
    assert linop.BatchScatter(AX, 1).T == linop.GradSumReduce(AX, 1)
    assert linop.GradSumReduce(AX, 0).T == linop.BatchScatter(AX, 0)
    assert (linop.CapacityRestrict(0, 6, 9).T
            == linop.CapacityRestrict(0, 6, 9, embed=True))
    assert linop.CapacityRestrict(0, 6, 9).T.T == linop.CapacityRestrict(0, 6,
                                                                          9)
    a, b = linop.Layout(AX, 0), linop.Layout(AX, 1)
    assert linop.Repartition(a, b).T == linop.Repartition(b, a)
    assert linop.Repartition(a, b).T.T == linop.Repartition(a, b)
    assert (linop.Repartition(linop.Layout(None), a).T
            == linop.Repartition(a, linop.Layout(None)))
    assert linop.Layout(None, 3) == linop.Layout(None)
    # the module's structural doctests (linop.py's docstrings)
    failed, tried = doctest.testmod(linop)
    assert tried >= 10 and failed == 0


def test_repartition_cross_axis_pieces(results):
    op = CASES["cross_axis"][1]
    assert op.pieces() == (linop.BatchScatter("model", 1),
                           linop.GradSumReduce("data", 0))
    _parity(results, "cross_axis", op)
    _parity(results, "cross_axis.T", op.T)


@pytest.mark.parametrize("seed", list(C.RANDOM_SEEDS))
def test_random_chains_pass_eq13(results, seed):
    chain = CASES[f"random_chain_{seed}"][1]
    _parity(results, f"random_chain_{seed}", chain)
    assert chain.T == linop.Compose(tuple(op.T for op in reversed(chain.ops)))
    assert chain.T.T == chain


def test_unbalanced_halo_from_partition_geometry(results):
    _parity(results, "halo_appB", CASES["halo_appB"][1])


@pytest.mark.parametrize("i", range(N_FUZZ))
def test_random_composites_pass_eq13_and_reversal(results, chains, i):
    ops = [C.build(linop, d) for d in chains[i]["ops"]]
    chain = C.chain_of(linop, chains[i]["ops"])
    _parity(results, f"fuzz{i}", chain)
    if isinstance(chain, linop.Compose):
        assert chain.T == linop.Compose(tuple(o.T for o in ops))
    else:
        assert chain.T == ops[0].T
    assert chain.T.T == chain


@pytest.mark.parametrize("cid", list(OP_SWEEP))
def test_every_op_on_mesh(results, cid):
    """Every concrete op and its adjoint along every axis of the (2, 4) and
    (2, 2, 2) meshes passes Eq. 13, (a) and (b), on every rank (each
    primitive beneath them is held to the JAX package on these meshes by
    tests/test_torch_primitives.py::test_primitive_on_mesh)."""
    for rank in results[0]:
        rel, rel_t = rank["sweep " + cid]
        assert rel < C.EPS and rel_t < C.EPS, (cid, rel, rel_t)


def test_new_dp_pair_in_adjoint_registry():
    ax = "data"
    assert linop.BatchScatter(ax, 1).T == linop.GradSumReduce(ax, 1)
    assert linop.GradSumReduce(ax, 1).T == linop.BatchScatter(ax, 1)
    assert linop.BatchScatter(ax, 0).T.T == linop.BatchScatter(ax, 0)


def _verdict(L, build, sizes, space):
    """``("ok", out space)`` or ``("reject", None)``: construction, then the
    space fold of ``space_map`` (the reference's typecheck folds the same
    signatures)."""
    try:
        op = build(L)
        if space is None:
            return "ok", None
        out = op.space_map(space(L), sizes)
    except L.SpaceTypeError:
        return "reject", None
    return "ok", (out.kind, out.local_shape, out.axis, out.dim)


def test_space_typing_matches_reference():
    """The port's space signatures accept the reference's exported
    composites, the pipeline boundary included, with the same codomains
    and reject its ill-typed ones (``repro/analysis/spaces.py:main``)."""
    from types import SimpleNamespace

    from repro.analysis import spaces
    from repro.core import linop as jlinop
    from repro_torch.core.pipeline import StageBoundary
    ops = SimpleNamespace(**vars(linop), StageBoundary=StageBoundary)
    sz = {"model": 8, "data": 8, "ctx": 4, "pipe": 4, "ep": 2}
    for name, op, sizes, space in spaces.exported_composites():
        trace = spaces.typecheck(op, sizes, space)
        desc = C.describe(op)

        def build(L, desc=desc):
            return C.build(ops, desc)

        def sp(L, s=space):
            return L.Space(s.kind, s.local_shape, s.axis, s.dim)
        want = ("ok", (trace.out_space.kind, trace.out_space.local_shape,
                       trace.out_space.axis, trace.out_space.dim))
        assert _verdict(linop, build, sizes, sp) == want, name
    St = lambda L, *a: L.Space.stacked(*a)   # noqa: E731
    negatives = [
        (lambda L: L.Broadcast("model") @ L.AllReduce("model"), None),
        (lambda L: L.SumReduce("model") @ L.SumReduce("model"), None),
        (lambda L: L.ReduceScatter("model", 0),
         lambda L: St(L, "model", 0, (5, 3))),
        (lambda L: L.AllGather("model", 1) @ L.KVRingShift("model", 1),
         lambda L: St(L, "model", 0, (2, 4))),
        (lambda L: L.AllGather("tp9", 0), lambda L: St(L, "tp9", 0, (2, 4))),
        (lambda L: L.AllReduce("model"), lambda L: St(L, "ctx", 0, (4, 3))),
        (lambda L: L.CapacityRestrict(0, 8, 9) @ L.AllToAll("ep", 1, 0),
         lambda L: St(L, "ep", 0, (4, 8))),
        (lambda L: L.CapacityRestrict(0, 7, 6), None),
        (lambda L: L.Repartition(L.Layout(None), L.Layout("model", 0)),
         lambda L: St(L, "ctx", 0, (4, 3))),
        (lambda L: L.Repartition(L.Layout("model", 1), L.Layout("data", 0)),
         lambda L: St(L, "model", 0, (2, 4))),
    ]
    for build, space in negatives:
        want = _verdict(jlinop, build, sz, space)
        assert want[0] == "reject"
        assert _verdict(linop, build, sz, space) == want
    with pytest.raises(SpaceTypeError):
        linop.Compose(())


@pytest.mark.parametrize("k", [2, 4, 8])
def test_move_registry_matches_reference(k):
    """The port's registry (``repro_torch.analysis.spaces``) offers the same
    moves, in the same order, as the reference's, over random start states
    and along random walks, and maps each to the same codomain; so the
    fuzzer's draws are the reference's."""
    from repro.analysis import spaces as jspaces
    from repro.core.linop import Space as JSpace
    from repro_torch.analysis import spaces

    def as_j(sp):
        return JSpace(sp.kind, sp.local_shape, sp.axis, sp.dim)

    rng = random.Random(k)
    for _ in range(150):
        rank = rng.randint(2, 3)
        if rng.randint(0, 1):
            space = linop.Space.stacked("tp", rng.randrange(rank),
                                        [rng.randint(1, 4)
                                         for _ in range(rank)])
        else:
            space = linop.Space.replicated([k * rng.randint(1, 2)
                                            for _ in range(rank)])
        for _ in range(rng.randint(1, 5)):
            got = spaces.legal_moves("tp", k, space, max_dim=MAX_DIM)
            assert got == jspaces.legal_moves("tp", k, as_j(space),
                                              max_dim=MAX_DIM), space
            if not got:
                break
            mv = rng.choice(got)
            _, new = spaces.apply_move("tp", k, space, mv)
            _, jnew = jspaces.apply_move("tp", k, as_j(space), mv)
            assert as_j(new) == jnew, (space, mv)
            space = new
