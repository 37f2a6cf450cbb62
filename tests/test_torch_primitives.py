"""The port's parallel primitives and meshes (``repro_torch/core/
primitives.py``, ``repro_torch/launch/mesh.py``) against the JAX package's.

One pool of 8 gloo ranks (``mesh.spawn``) runs every case while a child
interpreter with 8 host devices runs the JAX side (``torch_dist_jax.py``),
both on the same numpy draws (``torch_dist_cases.py``).  The cases mirror
tests/md/test_primitive_adjoints.py one for one; ``test_primitive_on_mesh``
adds every primitive along every axis of the (2, 4) and (2, 2, 2) meshes,
and ``test_unequal_block_collective_adjoint`` and
``test_unequal_block_gather_scatter_pair`` the port's collectives of
unequal blocks (Eq. 13 and their forwards; no JAX counterpart), on a
(2, 3) mesh of 6 of the 8 ranks as well.

Each case holds: Eq. 13 on the port's side (per-rank autograd through the
hand-written backwards, the inner product over the global space) at the
reference's pin 1e-4; the assembled global forward equal to JAX's
(bitwise for pure data movement, 1e-6 relative where a sum's order may
differ); the global vector-Jacobian product within 1e-5.  Per-rank
cotangents are not compared: they differ by design (README, "Cotangent
convention").
"""

import numpy as np
import pytest
import torch

import torch_dist_cases as C
from repro_torch.core import primitives as prim
from repro_torch.core.adjoint import adjoint_test
from repro_torch.core.partition import balanced_split, shard_offsets
from repro_torch.core.linop import P, assemble, scatter, spec_groups
from repro_torch.launch import dist_check, mesh as tmesh

POOL_TIMEOUT_S = 600
PRIM_CASES = C.prim_cases()
SWEEP_CASES = C.sweep_cases()
# The collectives of unequal blocks, ``all_gather_replicated_v`` and
# ``all_to_all_v`` (the port's alone: GSPMD pads instead): id -> (name,
# mesh, axis, n), each split dim the balanced split of n (the gather's)
# or of n and n + 1 (the all-to-all's rows and columns) over the axis.
# n = 5 over 8 ranks leaves ranks 5-7 empty blocks (zero rows; zero
# columns on ranks 6 and 7), as a model axis larger than a head count
# does.
UNEQUAL = {f"{name}-{mesh}-{ax}" + ("-empty" if n == 5 and mesh == "1d"
                                    else ""): (name, mesh, ax, n)
           for name in ("all_gather_replicated_v", "all_to_all_v")
           for mesh, ax, n in (("1d", "model", 13), ("2d", "model", 10),
                               ("2d", "data", 5), ("3d", "pipe", 3),
                               ("1d", "model", 5))}
# The partitioned pair over unequal blocks, ``all_gather`` and
# ``reduce_scatter`` with ``sizes`` (the paper's B and R over the balanced
# split):
# id -> (name, mesh, axis, n), n over 3 ranks on the (2, 3) mesh (6 of the
# 8 ranks) and over 4 and 2 on the (2, 4) one; n = 2 over 3 and 3 over 4
# leave the last rank an empty block.  Each case has an id of its own.
MESH_2X3 = ((2, 3), ("data", "model"))
PAIR_V = {f"{name}-{tag}": (name, mesh, ax, n)
          for name in ("all_gather_v", "reduce_scatter_v")
          for tag, mesh, ax, n in (
              ("2x3-model-7", "2x3", "model", 7),
              ("2x3-model", "2x3", "model", 8),
              ("2d-model", "2d", "model", 10), ("2d-data", "2d", "data", 5),
              ("2x3-model-empty", "2x3", "model", 2),
              ("2d-model-empty", "2d", "model", 3))}
NORM_D = 64      # rmsnorm_sharded's width: 22, 21, 21 over 3 ranks


def _eval(case, m) -> dict:
    """One case on this rank: Eq. 13 on the local shards, and the global
    forward and vjp through scatter -> body -> assemble."""
    body = case["body"](prim, prim.axis_index, True)
    specs = [P(*s) for s in case["specs"]]
    out_spec = P(*case.get("torch_out", case["out"]))
    lin = case["lin"]
    inputs = [torch.from_numpy(a) for a in case["inputs"]]
    with prim.use_mesh(m):
        locs = [scatter(t, s) for t, s in zip(inputs, specs)]

        def local(v):
            return body(*locs[:lin], v, *locs[lin + 1:])
        with torch.no_grad():
            fx = assemble(local(locs[lin].clone()), out_spec)
        y = case.get("y")
        if y is None:
            y = C.draw(tuple(fx.shape), case["seed"])
        y = torch.from_numpy(case.get("torch_y", lambda a: a)(y))
        rel = adjoint_test(local, locs[lin], scatter(y, out_spec),
                           x_groups=spec_groups(specs[lin], m),
                           y_groups=spec_groups(out_spec, m)).rel_err
        xg = inputs[lin].clone().requires_grad_()
        args = inputs[:lin] + [xg] + inputs[lin + 1:]
        out = assemble(body(*[scatter(t, s) for t, s in zip(args, specs)]),
                       out_spec)
        (vjp,) = torch.autograd.grad(out, xg, y)
    return {"fx": fx, "vjp": vjp, "rel": rel}


def _unequal(cid, m) -> dict:
    """One collective of unequal blocks on this rank: Eq. 13, and its
    forward against the global array X (n, n + 1, 3): the gather takes
    row block i of X on rank i to X on every rank, the all-to-all column
    block i to row block i."""
    name, _, ax, n = UNEQUAL[cid]
    X = torch.from_numpy(C.draw((n, n + 1, 3), C.seed_of(cid)))
    group = spec_groups(P(ax), m)
    with prim.use_mesh(m):
        k, me = prim.axis_size(ax), prim.axis_index(ax)
        rows = shard_offsets(n, k)
        mine = X[rows[me]:rows[me + 1]]
        if name == "all_gather_replicated_v":
            x, want, y_groups = mine, X, []

            def f(t):
                return prim.all_gather_replicated_v(t, ax, 0,
                                                    balanced_split(n, k))
        else:
            cols = shard_offsets(n + 1, k)
            x, want, y_groups = X[:, cols[me]:cols[me + 1]], mine, group

            def f(t):
                return prim.all_to_all_v(t, ax, 0, 1, balanced_split(n, k),
                                         balanced_split(n + 1, k))
        with torch.no_grad():
            exact = torch.equal(f(x.clone()), want)
        rel = adjoint_test(f, x.clone(), x_groups=group,
                           y_groups=y_groups).rel_err
    return {"exact": exact, "rel": rel}


def _pair_v(cid, m) -> dict:
    """One collective of the partitioned pair on this rank: Eq. 13 (the
    input and the output stacked over the axis), the forward against
    numpy, and the even collective's exact result at equal counts.  The
    gather takes row block i of X (n, 4, 3) on rank i to X on every rank;
    the reduce-scatter takes rank r's own draw X_r to block i of the sum
    over r of X_r."""
    name, _, ax, n = PAIR_V[cid]
    group = spec_groups(P(ax), m)
    with prim.use_mesh(m):
        k, me = prim.axis_size(ax), prim.axis_index(ax)
        sizes, rows = balanced_split(n, k), shard_offsets(n, k)
        draws = {r: C.draw((n, 4, 3), C.seed_of(f"{cid}-{r}"))
                 for r in range(k)}
        even = torch.from_numpy(C.draw((3 * k, 4, 3), C.seed_of(cid)))
        if name == "all_gather_v":
            X = torch.from_numpy(draws[0])
            x, want = X[rows[me]:rows[me + 1]], X.numpy()

            def f(t):
                return prim.all_gather(t, ax, 0, sizes)
            mine = even[3 * me:3 * me + 3]
            exact = torch.equal(prim.all_gather(mine, ax, 0, [3] * k),
                                prim.all_gather(mine, ax, 0))
        else:
            x = torch.from_numpy(draws[me])
            want = sum(draws.values())[rows[me]:rows[me + 1]]

            def f(t):
                return prim.reduce_scatter(t, ax, 0, sizes)
            exact = torch.equal(prim.reduce_scatter(even, ax, 0, [3] * k),
                                prim.reduce_scatter(even, ax, 0))
        with torch.no_grad():
            got = f(x.clone()).numpy()
        rel = adjoint_test(f, x.clone(), x_groups=group,
                           y_groups=group).rel_err
    return {"got": got, "want": want, "rel": rel, "exact": exact}


def _norm_unequal(m) -> dict:
    """``rmsnorm_sharded`` of this rank's block of the balanced split of
    d = NORM_D over the (2, 3) mesh's model axis, gathered whole, against
    ``rmsnorm`` on the whole rows."""
    from repro_torch.models.common import rmsnorm, rmsnorm_sharded
    x = torch.from_numpy(C.draw((5, NORM_D), C.seed_of("norm-x")))
    w = torch.from_numpy(C.draw((NORM_D,), C.seed_of("norm-w")))
    with prim.use_mesh(m):
        k, me = prim.axis_size("model"), prim.axis_index("model")
        offs = shard_offsets(NORM_D, k)
        block = rmsnorm_sharded(x[:, offs[me]:offs[me + 1]],
                                w[offs[me]:offs[me + 1]], "model", NORM_D)
        got = prim.all_gather(block, "model", 1, balanced_split(NORM_D, k))
    return {"got": got, "want": rmsnorm(x, w), "width": block.shape[1]}


def _mesh_facts(rank) -> dict:
    """The mesh builders on this world of 8 ranks."""
    facts = {}
    for name, build in {
            "hybrid_222": lambda: tmesh.make_hybrid_mesh(2, 2, tp=2,
                                                         device="cpu"),
            "hybrid_2122": lambda: tmesh.make_hybrid_mesh(2, 1, cp=2, tp=2,
                                                          device="cpu"),
            "hybrid_21122": lambda: tmesh.make_hybrid_mesh(
                2, 1, cp=1, tp=2, ep=2, device="cpu"),
            "pipeline_42": lambda: tmesh.make_pipeline_mesh(4, 2,
                                                            device="cpu"),
            "host_18": lambda: tmesh.make_host_mesh((1, 8),
                                                    device="cpu")}.items():
        m = build()
        facts[name] = {"axes": list(m.mesh_dim_names),
                       "shape": list(m.mesh.shape),
                       "coord": list(m.get_coordinate())}
    m = tmesh.make_hybrid_mesh(2, 2, tp=2, device="cpu")
    survivors = tmesh.surviving_devices(m, "data")
    degraded = tmesh.make_hybrid_mesh(1, 2, tp=2, devices=survivors,
                                      device="cpu")
    facts["survivors"] = survivors
    facts["degraded"] = (None if degraded is None
                         else degraded.mesh.tolist())
    for name, build in {
            "oversubscribe": lambda: tmesh.make_hybrid_mesh(2, 2, 1, 4,
                                                            device="cpu"),
            "lost_axis": lambda: tmesh.surviving_devices(m, "ctx"),
            "cuda_mesh": lambda: tmesh.make_host_mesh((8,), ("model",),
                                                      device="cuda")}.items():
        try:
            build()
            facts[name] = "accepted"
        except (ValueError, RuntimeError) as e:
            facts[name] = f"{type(e).__name__}: {e}"
    with prim.use_mesh(m):
        try:
            prim.batch_scatter(torch.zeros(3, 2), "data", 0)
            facts["batch_scatter_3_by_2"] = "accepted"
        except ValueError as e:
            facts["batch_scatter_3_by_2"] = str(e)
    facts["rank"] = rank
    return facts


def _rank_fn(rank, mesh1d):
    meshes = {"1d": mesh1d}
    for name in ("2d", "3d"):
        shape, axes = C.MESHES[name]
        meshes[name] = tmesh.make_host_mesh(shape, axes, device="cpu")
    out = {cid: _eval(case, meshes[case["mesh"]])
           for cid, case in {**PRIM_CASES, **SWEEP_CASES}.items()}
    out["unequal"] = {cid: _unequal(cid, meshes[UNEQUAL[cid][1]])
                      for cid in UNEQUAL}
    # ranks 6 and 7 are outside the (2, 3) mesh (None) and skip its cases
    meshes["2x3"] = tmesh.make_host_mesh(*MESH_2X3, device="cpu")
    out["pair_v"] = {cid: _pair_v(cid, meshes[PAIR_V[cid][1]])
                     for cid in PAIR_V if meshes[PAIR_V[cid][1]] is not None}
    if meshes["2x3"] is not None:
        out["norm_v"] = _norm_unequal(meshes["2x3"])
    # tests/md/test_primitive_adjoints.py: the analytic gradient of the
    # boundary case, sum over w of x * B(w), at w = 1
    x = torch.from_numpy(PRIM_CASES["boundary_transpose"]["inputs"][0])
    w = torch.ones(2, requires_grad=True)
    with prim.use_mesh(mesh1d):
        f = assemble(scatter(x, P("model")) * prim.broadcast(w, "model"),
                     P("model"))
        (out["boundary_grad"],) = torch.autograd.grad(f.sum(), w)
    out["mesh"] = _mesh_facts(rank)
    out["dist_check"] = dist_check.suite(rank, mesh1d,
                                         shapes=dist_check.SMALL,
                                         time_iters=1)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "primitives.npz"
    child = C.start_jax("primitives", path)
    try:
        ranks = tmesh.spawn(_rank_fn, 8, device="cpu",
                            timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = C.finish_jax(child, path)
    return ranks, jax_out


def _case(results, cid):
    """The port's results for ``cid`` (every rank holds the same global
    arrays) and the JAX side's."""
    ranks, jax_out = results
    port = ranks[0][cid]
    for r, other in enumerate(ranks[1:], 1):
        for key in ("fx", "vjp"):
            np.testing.assert_array_equal(other[cid][key], port[key],
                                          err_msg=f"rank {r} {key}")
    ref = {k: jax_out[f"{cid}/{k}"] for k in ("fx", "vjp", "rel")}
    return port, ref


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _parity(results, cid, cases=PRIM_CASES):
    case = cases[cid]
    port, ref = _case(results, cid)
    assert port["rel"] < C.EPS, (cid, port["rel"])
    assert ref["rel"] < C.EPS, (cid, ref["rel"])
    fx = port["fx"]
    if "torch_out" in case:   # equal copies stacked over the extra axis
        fx = fx.reshape((-1,) + ref["fx"].shape)
    else:
        fx = fx[None]
    for block in fx:
        if case["exact"]:
            np.testing.assert_array_equal(block, ref["fx"], err_msg=cid)
        else:
            _close(block, ref["fx"], C.FWD_RTOL, cid)
    _close(port["vjp"], ref["vjp"], C.GRAD_TOL, cid)
    return port, ref


def test_broadcast_sum_reduce_pair(results):
    _parity(results, "broadcast_sum_reduce_pair")


def test_boundary_transpose_is_papers_broadcast_adjoint(results):
    # The port's explicit B, whose backward all-reduces, does what
    # shard_map's boundary transpose does in JAX (DESIGN.md §2).
    _parity(results, "boundary_transpose")
    x = PRIM_CASES["boundary_transpose"]["inputs"][0]
    np.testing.assert_allclose(results[0][0]["boundary_grad"],
                               x.reshape(8, 2).sum(0), rtol=1e-5)


def test_sum_reduce_adjoint_is_broadcast(results):
    port, _ = _parity(results, "sum_reduce")
    x = PRIM_CASES["sum_reduce"]["inputs"][0]
    np.testing.assert_allclose(port["fx"], x.reshape(8, 2, 3).sum(0),
                               rtol=1e-5)


def test_all_reduce_self_adjoint(results):
    port, _ = _parity(results, "all_reduce")
    x = PRIM_CASES["all_reduce"]["inputs"][0]
    expect = np.tile(x.reshape(8, 1, 4).sum(0), (8, 1)).reshape(8, 4)
    np.testing.assert_allclose(port["fx"], expect, rtol=1e-5)


def test_all_gather_adjoint_is_reduce_scatter(results):
    port, _ = _parity(results, "all_gather")
    x = PRIM_CASES["all_gather"]["inputs"][0]
    y = port["fx"].reshape(8, 16, 3)
    for i in range(8):
        np.testing.assert_allclose(y[i], x * (i + 1), rtol=1e-5)


def test_reduce_scatter_adjoint_is_all_gather(results):
    port, _ = _parity(results, "reduce_scatter")
    xx = PRIM_CASES["reduce_scatter"]["inputs"][0].reshape(16, 8, 5)
    expect = np.stack([xx[2 * j:2 * j + 2].sum(1)
                       for j in range(8)]).reshape(16, 5)
    np.testing.assert_allclose(port["fx"], expect, rtol=1e-5)


def test_all_to_all_adjoint_is_reverse(results):
    port, _ = _parity(results, "all_to_all")
    np.testing.assert_array_equal(port["fx"],
                                  PRIM_CASES["all_to_all"]["inputs"][0])


def test_send_recv_adjoint_reverses(results):
    port, _ = _parity(results, "send_recv")
    y = port["fx"].reshape(8, 2, 2)
    xx = PRIM_CASES["send_recv"]["inputs"][0].reshape(8, 2, 2)
    np.testing.assert_array_equal(y[1:], xx[:-1])
    np.testing.assert_array_equal(y[0], 0)


@pytest.mark.parametrize("left,right", C.HALO_WIDTHS)
def test_halo_exchange_adjoint(results, left, right):
    _parity(results, f"halo_{left}_{right}")


def test_halo_exchange_forward_semantics(results):
    port, _ = _parity(results, "halo_forward_semantics")
    y = port["fx"].reshape(8, 7)
    for i in range(8):
        bulk = np.arange(4 * i, 4 * i + 4)
        lm = np.arange(4 * i - 2, 4 * i) if i > 0 else np.zeros(2)
        rm = np.array([4 * i + 4]) if i < 7 else np.zeros(1)
        np.testing.assert_array_equal(y[i], np.concatenate([lm, bulk, rm]))


def test_halo_adjoint_adds_into_bulk(results):
    # The paper's key observation (§3): H* ADDS margin cotangents into the
    # neighbour's bulk.
    port, _ = _parity(results, "halo_adds_into_bulk")
    xb = port["vjp"].reshape(8, 2)
    assert xb[0, 0] == 1 and xb[0, 1] == 2
    assert all(xb[i, 0] == 2 and xb[i, 1] == 2 for i in range(1, 7))
    assert xb[7, 0] == 2 and xb[7, 1] == 1


def test_halo_exchange_unbalanced(results):
    _parity(results, "halo_unbalanced")
    port, _ = _parity(results, "halo_unbalanced_ones")
    y = port["fx"].reshape(8, -1, 2)
    lmax, rmax, bulk = 2, 2, 4
    for i in range(8):
        want = np.zeros(lmax + bulk + rmax)
        lo = lmax - (C.UNBAL_LW[i] if i > 0 else 0)
        hi = lmax + bulk + (C.UNBAL_RW[i] if i < 7 else 0)
        want[lo:hi] = 1
        np.testing.assert_array_equal(y[i, :, 0], want, err_msg=f"worker {i}")


@pytest.mark.parametrize("cid", sorted(UNEQUAL))
def test_unequal_block_collective_adjoint(results, cid):
    """Eq. 13 for the collectives of unequal blocks on every rank (the
    gather's adjoint the restriction to the rank's block, the
    all-to-all's the reverse all-to-all), and their forwards exact: the
    gather returns the whole array on every rank, the all-to-all moves
    the balanced column split to the balanced row split."""
    ranks, _ = results
    for r, rank in enumerate(ranks):
        got = rank["unequal"][cid]
        assert got["exact"], (cid, r)
        assert got["rel"] < C.EPS, (cid, r, got["rel"])


@pytest.mark.parametrize("cid", sorted(PAIR_V))
def test_unequal_block_gather_scatter_pair(results, cid):
    """Eq. 13 for the partitioned pair of unequal blocks on every rank of
    its mesh (``all_gather``'s adjoint ``reduce_scatter``, with sizes, and
    back),
    the forwards against numpy (the gather exact, the scatter's sum within
    1e-6 of scale), and equal counts giving exactly the even
    ``all_gather`` and ``reduce_scatter``."""
    ranks, _ = results
    world = 6 if PAIR_V[cid][1] == "2x3" else 8
    assert [cid in rank["pair_v"] for rank in ranks] == [True] * world + [
        False] * (8 - world)
    for r, got in enumerate(rank["pair_v"][cid] for rank in ranks[:world]):
        assert got["rel"] < C.EPS, (cid, r, got["rel"])
        assert got["exact"], (cid, r)
        if cid.startswith("all_gather_v"):
            np.testing.assert_array_equal(got["got"], got["want"])
        else:
            _close(got["got"], got["want"], C.FWD_RTOL, f"{cid} rank {r}")


def test_rmsnorm_sharded_over_unequal_feature_blocks(results):
    """``rmsnorm_sharded`` over the balanced split of d = 64 on 3 ranks
    (22, 21, 21 features) equals ``rmsnorm`` of the whole rows."""
    ranks, _ = results
    widths = [rank["norm_v"]["width"] for rank in ranks[:6]]
    assert widths == [22, 21, 21] * 2
    for r, rank in enumerate(ranks[:6]):
        got = rank["norm_v"]
        _close(got["got"], got["want"], C.FWD_RTOL, f"rank {r}")


def test_2d_mesh_composed_axes(results):
    # broadcast over one axis, sum-reduce over the other (conv pattern);
    # the port's output is typed stacked over "data" (two equal copies).
    _parity(results, "compose_2d")


@pytest.mark.parametrize("cid", list(SWEEP_CASES))
def test_primitive_on_mesh(results, cid):
    _parity(results, cid, SWEEP_CASES)


@pytest.mark.parametrize("cid", [c for c in SWEEP_CASES
                                 if SWEEP_CASES[c]["own"]])
def test_replicated_pair_is_the_batch_pair(results, cid):
    """The JAX package's replicated pair assumes the replicated cotangent
    (DESIGN §4), which shard_map's lifted boundary does not pass: lifted,
    its vjp is the adjoint over k (all_gather_replicated) or times k
    (shard_slice_replicated) on a k-way axis, so it fails Eq. 13, while
    its forward equals the port's.  The port's pair, in the explicit-copy
    convention, passes and equals JAX's grad_sum_reduce / batch_scatter in
    forward and vjp (``test_primitive_on_mesh``)."""
    port, _ = _case(results, cid)
    own = {k: results[1][f"{cid}/own_{k}"] for k in ("fx", "vjp", "rel")}
    name, mesh, axis = cid.split("-")
    k = dict(zip(*reversed(C.MESHES[mesh])))[axis]
    scale = 1 / k if name == "all_gather_replicated" else k
    assert port["rel"] < C.EPS
    assert own["rel"] > C.EPS, own["rel"]
    np.testing.assert_array_equal(port["fx"], own["fx"])
    _close(own["vjp"], scale * port["vjp"], C.GRAD_TOL, cid)


def test_hybrid_mesh_axes_and_elision(results):
    import repro.launch.mesh as jmesh   # its mesh-free helpers only
    for facts in results[0]:
        m = facts["mesh"]
        assert m["hybrid_222"]["axes"] == ["data", "pipe", "model"]
        assert m["hybrid_2122"]["axes"] == ["data", "pipe", "ctx", "model"]
        assert m["hybrid_21122"]["axes"] == ["data", "pipe", "ctx", "model",
                                             "ep"]
        assert m["hybrid_21122"]["shape"] == [2, 1, 1, 2, 2]
        assert m["pipeline_42"]["axes"] == ["pipe", "model"]
        r = m["rank"]
        assert m["hybrid_222"]["coord"] == [r // 4, (r // 2) % 2, r % 2]
        assert m["host_18"]["coord"] == [0, r]
        assert m["survivors"] == [0, 1, 2, 3]
        assert m["degraded"] == ([[[0, 1], [2, 3]]] if r < 4 else None)
        assert m["oversubscribe"].startswith(
            "ValueError: hybrid mesh factorization dp*S*cp*tp*ep = "
            "2x2x1x4x1 = 16 oversubscribes the 8 available device(s)")
        assert m["lost_axis"].startswith("ValueError: mesh has no axis 'ctx'")
        assert m["cuda_mesh"].startswith("RuntimeError: no CUDA device")
        assert "not divisible by axis 'data' size 2" in m[
            "batch_scatter_3_by_2"]
    for fact, lost in [((2, 2, 1, 2, 1), "data"), ((1, 4, 1, 2, 1), "pipe"),
                       ((1, 1, 6, 1, 1), "ctx"), ((8, 1, 1, 1, 1), "data")]:
        assert (tmesh.shrink_factorization(fact, lost)
                == jmesh.shrink_factorization(fact, lost))


def test_dist_check_suite_on_host(results):
    """The card's Eq. 13 suite (chip_smoke.py's dist phase) at its small
    shapes on the 8 gloo ranks: every check passes on every rank, the
    collectives of unequal blocks with an empty one included."""
    for res in (r["dist_check"] for r in results[0]):
        assert res["world"] == 8 and res["backend"] == "gloo"
        assert len(res["rel_err"]) == 51 and not res["failed"], res["failed"]
        assert sum("an empty block" in c for c in res["rel_err"]) == 4
        assert {t["name"] for t in res["timing"]} >= {
            "AllReduce", "AllGather", "ReduceScatter", "AllToAll",
            "SendRecv", "KVRingShift", "HaloExchange", "HaloAccumulate"}


def test_cuda_mesh_needs_one_card_per_rank():
    # The backend follows the device: a CUDA world larger than the cards
    # present raises before any process starts, never falls back to gloo.
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one rank per card"):
        tmesh._check_world(cards + 1, "cuda")
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.spawn(_rank_fn, cards + 1, device="cuda", timeout_s=30)
