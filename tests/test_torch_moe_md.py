"""The port's expert parallelism against the JAX package on 8 ranks: every
case of tests/md/test_moe_md.py at that file's pins, on one pool of 8 gloo
ranks beside a child interpreter with 8 host devices
(``torch_moe_jax.py``) that computes the reference on the same parameters
and inputs (the reference's own draws, carried over as numpy).

- ``moe_apply`` over (data, model) = (2, 4) with FSDP, experts over the
  model axis: y and aux (2e-4) and the grads of ``sum(y ** 2) + 0.01 aux``
  (5e-4) against the reference's region and its dense path;
- capacity 0.5: the same drops twice, bitwise, and finite;
- ep = 4: each rank's block dispatched alone drops the same token set as
  the reference's per-block local dispatch;
- ep = 8: eight experts, one a rank;
- E not divisible by ep raises before anything runs;
- the hybrid executor on (dp, ep) = (2, 4) and (ep, tp) = (4, 2) against
  the single-device mesh: loss rtol 1e-5, grads atol 1e-5 / rtol 2e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_moe_cases as C
import torch_region_cases as RC
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.specs import expert_assignment
from repro_torch.models.convert import params_from_jax, to_rank_params
from repro_torch.models.moe import moe_apply
from repro_torch.sharding import Policy
from repro_torch.train import build_hybrid_value_and_grad

POOL_TIMEOUT_S = 300


def _configs():
    cfg = dataclasses.replace(reduced(get_config(C.ARCH)),
                              capacity_factor=C.CAPACITY)
    tight = dataclasses.replace(cfg, capacity_factor=C.TIGHT)
    tight1 = dataclasses.replace(tight, experts_per_token=1,
                                 num_shared_experts=0)
    big = dataclasses.replace(cfg, num_experts=C.BIG_E, capacity_factor=8.0)
    return cfg, tight, tight1, big


def _hybrid(init, shape):
    """(loss, grads) of the hybrid executor on the (dp, S, cp, tp, ep) mesh
    ``shape``; None on ranks outside it."""
    cfg = ModelConfig(**C.HYBRID_CFG)
    mesh = tmesh.make_hybrid_mesh(*shape[:2], cp=shape[2], tp=shape[3],
                                  ep=shape[4], device="cpu")
    if mesh is None:
        return None
    pol = Policy.for_mesh(mesh, explicit_tp=True)
    pvg, _ = build_hybrid_value_and_grad(cfg, pol,
                                         num_microbatches=C.HYBRID_M)
    mbs = {k: torch.from_numpy(init[f"hybrid/{k}"]).long().reshape(
        C.HYBRID_M, -1, C.HYBRID_SEQ) for k in ("tokens", "labels")}
    params = params_from_jax(C.subtree(init, "hybrid/params"))
    loss, grads = pvg(params, {"tokens": mbs["tokens"]}, mbs["labels"])
    # this rank's expert block, against the experts expert_assignment names
    block = to_rank_params(cfg, pol, params)["stage.pos1.moe.we_up"]
    ep_index = (mesh.get_coordinate()[pol.axis_names.index("ep")]
                if pol.active_ep_axis else 0)
    mine = expert_assignment(cfg.num_experts, pol.ep_size)[ep_index]
    want = params["stage.pos1.moe.we_up"][:, :, mine.start:mine.stop]
    return {"loss": float(loss), "grads": grads,
            "experts": [mine.start, mine.stop, bool(torch.equal(block, want))]}


def _rank_fn(rank, mesh1d, init):
    cfg, tight, tight1, big = _configs()
    p = params_from_jax(C.subtree(init, "p"))
    x = {case: torch.from_numpy(init[f"x/{case}"]) for case in C.X_SHAPE}
    out = {}
    pol2d = Policy(tmesh.make_host_mesh((2, 4), ("data", "model"),
                                        device="cpu"))
    y, aux = moe_apply(x["fwd"], p, cfg, pol2d)
    out["fwd"] = {"y": y, "aux": aux}
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, aux = moe_apply(x["grads"], leaves, cfg, pol2d)
    grads = torch.autograd.grad((y ** 2).sum() + C.AUX_WEIGHT * aux,
                                list(leaves.values()))
    out["grads"] = dict(zip(leaves, grads))
    out["drops"] = [moe_apply(x["drops"], p, tight, pol2d)[0]
                    for _ in range(2)]
    m4 = tmesh.make_host_mesh((4,), ("ep",), device="cpu")
    if m4 is not None:
        pol4 = Policy.for_mesh(m4)
        out["drop_set"] = moe_apply(x["drop_set"], p, tight1, pol4)[0]
        bad = dataclasses.replace(cfg, num_experts=cfg.num_experts + 1)
        try:
            moe_apply(x["raise"], p, bad, pol4)
            out["raise"] = ""
        except ValueError as e:
            out["raise"] = str(e)
    pol8 = Policy.for_mesh(tmesh.make_host_mesh((8,), ("ep",), device="cpu"))
    out["big_e"] = moe_apply(x["big_e"], params_from_jax(
        C.subtree(init, "p8")), big, pol8)[0]
    for name, shape in C.HYBRID_MESHES.items():
        res = _hybrid(init, shape)
        if res is not None:
            out[name] = res if rank == 0 else {"loss": res["loss"]}
            out[name]["experts"] = res["experts"]
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "moe.npz"
    child = C.start_jax(path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, jax_out


def _close(got, want, tol, msg="", rtol=None):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), atol=tol,
                               rtol=tol if rtol is None else rtol,
                               err_msg=msg)


@pytest.mark.parametrize("want", ["ep", "ref"])
def test_ep_matches_reference(results, want):
    """Every rank's assembled y against the reference's EP region and its
    dense path, and aux against the region's (the mean of the 8 shards'
    local statistics, not the dense path's global one)."""
    ranks, jax_out = results
    for rank, r in enumerate(ranks):
        _close(r["fwd"]["y"], jax_out[f"fwd/{want}/y"], C.Y_TOL,
               f"rank {rank} y")
        if want == "ep":
            _close(r["fwd"]["aux"], jax_out["fwd/ep/aux"], C.Y_TOL, "aux")


@pytest.mark.parametrize("want", ["ep", "ref"])
def test_ep_gradients_match_reference(results, want):
    ranks, jax_out = results
    ref = C.subtree(jax_out, f"grads/{want}")
    for r in ranks:
        assert set(r["grads"]) == set(ref)
        for k, g in r["grads"].items():
            _close(g, ref[k], C.GRAD_TOL, k)


def test_capacity_drops_are_deterministic(results):
    """Capacity 0.5: two runs bitwise equal, finite (dropped tokens pass
    through with zero expert output, not NaN), and equal to the
    reference's run."""
    ranks, jax_out = results
    for r in ranks:
        y1, y2 = r["drops"]
        np.testing.assert_array_equal(y1, y2)
        assert np.isfinite(y1).all()
        _close(y1, jax_out["drops/y"], C.Y_TOL)


def test_ep_drop_set_matches_per_block_local_dispatch(results):
    """On ep = 4 the batch is sub-sharded over ep and each rank dispatches
    its own block: the set of dropped tokens (rows combining to exactly
    zero; k = 1, so gates are 1) of each block equals the reference's
    unsharded dispatch of that block."""
    ranks, jax_out = results
    ref = jax_out["drop_set/ref"]
    drops = 0
    for r in ranks[:4]:
        got = r["drop_set"]
        _close(got, ref, C.Y_TOL)
        np.testing.assert_array_equal(np.all(got == 0.0, axis=-1),
                                      np.all(ref == 0.0, axis=-1))
        drops = int(np.all(got == 0.0, axis=-1).sum())
    assert drops > 0   # capacity 0.5 must drop tokens
    for r in ranks[4:]:
        assert "drop_set" not in r   # outside the 4-rank mesh


@pytest.mark.parametrize("want", ["ep", "ref"])
def test_big_E_ep8_matches_reference(results, want):
    """Eight experts over ep = 8, one a rank, at drop-free capacity."""
    ranks, jax_out = results
    for r in ranks:
        _close(r["big_e"], jax_out[f"big_e/{want}"], C.Y_TOL)


@pytest.mark.parametrize("mesh", ["dp_ep", "ep_tp"])
def test_rank_params_hold_the_assigned_expert_block(results, mesh):
    """``to_rank_params`` gives each rank the contiguous block of E/ep
    experts that ``launch/specs.py::expert_assignment`` names for its ep
    index, and the blocks cover every expert."""
    ranks, _ = results
    blocks = set()
    for r in ranks:
        start, stop, equal = r[mesh]["experts"]
        assert equal and stop - start == 1   # E 4 over ep 4
        blocks.add((start, stop))
    assert blocks == {(e, e + 1) for e in range(4)}


def test_num_experts_not_divisible_by_ep_raises(results):
    ranks, _ = results
    for r in ranks[:4]:
        assert "not divisible by ep" in r["raise"], r["raise"]


@pytest.mark.parametrize("mesh", ["dp_ep", "ep_tp"])
def test_hybrid_ep_meshes_match_reference_loss_and_grads(results, mesh):
    """(dp, ep) = (2, 4) and (ep, tp) = (4, 2) against the single-device
    mesh, the port's and the reference's: loss on every rank, every grad
    leaf (capacity covers the worst-case load, so nothing drops)."""
    ranks, jax_out = results
    for ref in ("ref", mesh):
        want_loss = jax_out[f"hybrid/{ref}/loss"]
        want = C.subtree(jax_out, f"hybrid/{ref}/grad")
        for r in ranks:
            _close(r[mesh]["loss"], want_loss, 0.0, f"{mesh} loss",
                   rtol=C.LOSS_RTOL)
        port = ranks[0][mesh]["grads"]
        assert set(port) == set(want)
        for k, g in port.items():
            _close(g, want[k], C.HYBRID_ATOL, f"{mesh} vs {ref}: {k}",
                   rtol=C.HYBRID_RTOL)
    own = ranks[0]["ref"]
    _close(ranks[0][mesh]["loss"], own["loss"], 0.0, rtol=C.LOSS_RTOL)
    for k, g in ranks[0][mesh]["grads"].items():
        _close(g, own["grads"][k], C.HYBRID_ATOL, f"{mesh} vs port: {k}",
               rtol=C.HYBRID_RTOL)
