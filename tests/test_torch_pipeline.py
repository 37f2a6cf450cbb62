"""The port's pipeline executor (``repro_torch/core/pipeline.py``), its
schedules, the pipeline cut of the model and ``launch/specs.py``, against
the JAX package.

Host-only: the schedule tables (``ops``, ``mbs``, ``recv_f``, ``recv_b``,
depths, bubble) equal ``repro.core.pipeline.make_schedule`` for every
(M, S) of tests/test_pipeline_schedule.py and both generators; the specs
helpers equal the reference's; the param cut round-trips and refuses an
uneven cut.  On one pool of 8 gloo ranks, beside a child interpreter with
8 host devices running the reference (``torch_pipeline_jax.py
pipeline``) on the same parameters and data: ``StageBoundary`` meets
Eq. 13 on the pipe axis of the 4x2 mesh at offsets 1, -1 and 2 and as a
composite, and the executor cases of tests/md/test_pipeline.py (4 stages
x 2-way TP, 1F1B and fill-drain, M = 6 over 4 stages, the single stage)
match the live JAX executor and the port's own single-device forward in
the loss (rtol 2e-5) and every grad leaf (rtol, atol 5e-4).
"""

import doctest
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_pipeline_cases as C
import torch_region_cases as RC
from repro.core import pipeline as jpipe
from repro_torch.configs import ModelConfig
from repro_torch.core import pipeline as tpipe
from repro_torch.core.linop import AllGather, SumReduce, check_adjoint
from repro_torch.core.pipeline import (StageBoundary, make_schedule,
                                       pipeline_value_and_grad)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import (from_pipeline_params, init_pipeline_params,
                                pipeline_fns, pipeline_param_parts,
                                to_pipeline_params)
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding import Partitioned, Policy
from repro_torch.train import build_loss_fn, cross_entropy

CFG = ModelConfig(**C.CFG)
POOL_TIMEOUT_S = 600
SCHEDULE_CASES = [(1, 1), (3, 1), (2, 4), (4, 4), (6, 4), (8, 4), (5, 3),
                  (12, 8)]        # tests/test_pipeline_schedule.py:16
BOUNDARY_CASES = {"offset 1": StageBoundary("pipe", 1),
                  "offset -1": StageBoundary("pipe", -1),
                  "offset 2": StageBoundary("pipe", 2),
                  "composite": StageBoundary("pipe") @ StageBoundary("pipe")}


# ---------------------------------------------------------------------------
# Host-only: the schedules, the specs, the cut.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,S", SCHEDULE_CASES)
@pytest.mark.parametrize("name", ["fill_drain", "1f1b"])
def test_schedule_tables_equal_reference(name, M, S):
    got, want = make_schedule(name, M, S), jpipe.make_schedule(name, M, S)
    assert (got.name, got.num_stages, got.num_microbatches) == (
        want.name, want.num_stages, want.num_microbatches)
    for table in ("ops", "mbs", "recv_f", "recv_b"):
        np.testing.assert_array_equal(getattr(got, table),
                                      getattr(want, table), err_msg=table)
    assert (got.fwd_depth, got.bwd_depth) == (want.fwd_depth, want.bwd_depth)
    assert got.num_ticks == want.num_ticks
    assert got.bubble_fraction() == want.bubble_fraction()
    assert got.counts() == want.counts()


def test_schedule_validation_and_doctests():
    with pytest.raises(ValueError, match="unknown schedule"):
        make_schedule("zero-bubble", 4, 2)
    with pytest.raises(ValueError, match="M >= 1"):
        tpipe.schedule_1f1b(0, 2)
    failed, tried = doctest.testmod(tpipe)
    assert tried >= 4 and failed == 0


def test_stage_boundary_adjoint_identity():
    assert StageBoundary("pipe").T == StageBoundary("pipe", -1)
    assert StageBoundary("pipe", 2).T.T == StageBoundary("pipe", 2)
    comp = StageBoundary("pipe") @ StageBoundary("pipe")
    assert comp.T == StageBoundary("pipe", -1) @ StageBoundary("pipe", -1)
    mixed = StageBoundary("pipe") @ AllGather("model", 1)
    assert mixed.T == AllGather("model", 1).T @ StageBoundary("pipe", -1)


def _meta(t):
    return (tuple(t.shape), str(t.dtype).split(".")[-1])


def _jmeta(s):
    return (tuple(s.shape), str(s.dtype))


def test_specs_equal_reference():
    from repro.configs import ModelConfig as JConfig
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.launch import specs as jspecs
    from repro_torch.configs import get_config, reduced

    for nl, S in ((4, 4), (4, 3), (4, 1), (8, 3)):
        jcfg = JConfig(**dict(C.CFG, num_layers=nl))
        tcfg = ModelConfig(**dict(C.CFG, num_layers=nl))
        assert (tspecs.stage_assignment(tcfg, S)
                == jspecs.stage_assignment(jcfg, S))
    for args in ((16, 2, 4), (8, 4, 2)):
        assert (tspecs.replica_assignment(*args)
                == jspecs.replica_assignment(*args))
    assert tspecs.context_assignment(32, 4) == jspecs.context_assignment(32, 4)
    assert tspecs.expert_assignment(8, 4) == jspecs.expert_assignment(8, 4)
    for fn, bad in ((tspecs.replica_assignment, (16, 3, 4)),
                    (tspecs.context_assignment, (30, 4)),
                    (tspecs.expert_assignment, (6, 4))):
        with pytest.raises(ValueError, match="not divisible"):
            fn(*bad)
    arch = "glm4-9b"
    tcfg, jcfg = reduced(get_config(arch)), jreduced(jget(arch))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        got = {k: _meta(v) for k, v in tspecs.input_specs(tcfg, shape).items()}
        want = {k: _jmeta(v)
                for k, v in jspecs.input_specs(jcfg, shape).items()}
        assert got == want, shape
    xs, ys = tspecs.hybrid_input_specs(tcfg, "train_4k", 8, dp=2)
    jxs, jys = jspecs.hybrid_input_specs(jcfg, "train_4k", 8, dp=2)
    assert (_meta(xs["tokens"]), _meta(ys)) == (_jmeta(jxs["tokens"]),
                                                _jmeta(jys))
    for bad in (dict(num_microbatches=7, dp=1), dict(num_microbatches=8,
                                                     dp=2, cp=4095)):
        with pytest.raises(ValueError, match="not divisible"):
            tspecs.hybrid_input_specs(tcfg, "train_4k", **bad)
    with pytest.raises(ValueError, match="train cell"):
        tspecs.pipeline_input_specs(tcfg, "decode_32k", 2)
    got = {k: _meta(v) for k, v in tspecs.param_specs(tcfg).items()}
    want = {k: _jmeta(v) for k, v in _flat(jspecs.param_specs(jcfg)).items()}
    assert got == want
    got = {k: _meta(v) for k, v in tspecs.cache_specs(tcfg,
                                                       "decode_32k").items()}
    want = {k: _jmeta(v) for k, v in _flat(jspecs.cache_specs(
        jcfg, "decode_32k")).items()}
    assert got == want


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_param_cut_roundtrip():
    """tests/md/test_pipeline.py::test_param_cut_roundtrip on the port's
    flat keys, and the cut of real parameters back to the dense layout."""
    pp = init_pipeline_params(CFG, torch.Generator().manual_seed(0), 4, "cpu")
    assert pp["stage.pos0.attn.wq"].shape[:2] == (4, 1)
    cut = to_pipeline_params(
        CFG, {"embed": torch.zeros(128, 64), "norm_final": torch.zeros(64),
              "lm_head": torch.zeros(64, 128),
              "blocks.pos0.norm_mixer": torch.zeros(4, 64)}, 2)
    assert cut["stage.pos0.norm_mixer"].shape == (2, 2, 64)
    back = from_pipeline_params(cut)
    assert back["blocks.pos0.norm_mixer"].shape == (4, 64)
    dense = from_pipeline_params(pp)
    again = to_pipeline_params(CFG, dense, 4)
    assert set(again) == set(pp)
    for k in pp:
        assert torch.equal(again[k], pp[k]), k


def test_uneven_stage_cut_raises():
    with pytest.raises(ValueError, match="uniformly"):
        init_pipeline_params(CFG, torch.Generator().manual_seed(0), 3, "cpu")


def test_tied_embeddings_refused():
    import dataclasses
    with pytest.raises(NotImplementedError, match="untied"):
        pipeline_fns(dataclasses.replace(CFG, tie_embeddings=True), None)


# ---------------------------------------------------------------------------
# The 8-rank pool against the JAX child.
# ---------------------------------------------------------------------------

def _single_device(pparams, tokens, labels):
    """The port's own single-device fp32 reference: per-microbatch forward
    and autograd, the dense layout (tests/md/test_pipeline.py)."""
    loss_fn = build_loss_fn(CFG)
    dense = {k: v.clone().requires_grad_() for k, v in
             from_pipeline_params(pparams).items()}
    M = tokens.shape[0]
    tot = sum(loss_fn(dense, {"tokens": tokens[m], "labels": labels[m]})[0]
              for m in range(M)) / M
    grads = torch.autograd.grad(tot, list(dense.values()))
    return float(tot), to_pipeline_params(CFG, dict(zip(dense, grads)),
                                          pparams["stage.pos0.attn.wq"]
                                          .shape[0])


def _executor(mesh, schedule, M, init):
    S = dict(zip(mesh.mesh_dim_names, mesh.shape))["pipe"]
    pol = Policy.for_mesh(mesh, explicit_tp=True)
    pparams = params_from_jax(C.subtree(init, f"p{S}"))
    tokens = torch.from_numpy(init[f"data/M{M}/tokens"]).long()
    labels = torch.from_numpy(init[f"data/M{M}/labels"]).long()
    pre_fn, stage_fn, logits_fn = pipeline_fns(CFG, pol)

    def post_fn(p_post, y, lab):
        return cross_entropy(logits_fn(p_post, y), lab)[0]

    f = pipeline_value_and_grad(
        pre_fn, stage_fn, post_fn, pol, make_schedule(schedule, M, S),
        params_parts=pipeline_param_parts(CFG, pol, pparams),
        x_parts={"tokens": Partitioned()}, y_parts=Partitioned(),
        pre_psum_axes=(pol.model_axis,))
    loss, grads = f(pparams, {"tokens": tokens}, labels)
    ref_loss, ref_grads = _single_device(pparams, tokens, labels)
    return {"loss": float(loss), "grads": grads, "ref_loss": ref_loss,
            "ref_grads": ref_grads}


def _rank_fn(rank, mesh1d, init):
    meshes = {k: tmesh.make_pipeline_mesh(*v, device="cpu")
              for k, v in C.PIPE_MESHES.items()}
    out = {"boundary": {}}
    m42 = meshes["4x2"]
    for cid, op in BOUNDARY_CASES.items():
        out["boundary"][cid] = check_adjoint(op, m42, (8, 6)).rel_err
    # the pipe x tensor composition: the model-axis collectives keep exact
    # adjoints on the same 2-D mesh
    out["boundary"]["model AllGather"] = check_adjoint(
        AllGather("model", 1), m42, (8, 6)).rel_err
    out["boundary"]["model SumReduce"] = check_adjoint(
        SumReduce("model"), m42, (8, 6)).rel_err
    for cid, (mname, schedule, M) in C.PIPE_CASES.items():
        if meshes[mname] is not None:
            res = _executor(meshes[mname], schedule, M, init)
            if rank:      # every rank holds the global values; keep rank 0's
                res = {"loss": res["loss"], "ref_loss": res["ref_loss"]}
            out[cid] = res
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "pipeline.npz"
    child = C.start_jax("pipeline", path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, jax_out


@pytest.mark.parametrize("cid", list(BOUNDARY_CASES) + ["model AllGather",
                                                        "model SumReduce"])
def test_stage_boundary_eq13_on_pipe_axis(results, cid):
    """Eq. 13 (a) and (b) on the pipe axis of the 4x2 mesh, on every rank,
    at the reference's pin 1e-4."""
    for r, rank in enumerate(results[0]):
        assert rank["boundary"][cid] < 1e-4, (cid, r, rank["boundary"][cid])


def _assert_close(loss, grads, want_loss, want_grads, what):
    np.testing.assert_allclose(loss, want_loss, rtol=C.LOSS_RTOL,
                               err_msg=f"{what} loss")
    assert set(grads) == set(want_grads), what
    for k, g in grads.items():
        np.testing.assert_allclose(np.asarray(g), np.asarray(want_grads[k]),
                                   rtol=C.GRAD_TOL, atol=C.GRAD_TOL,
                                   err_msg=f"{what} grad {k}")


@pytest.mark.parametrize("cid", list(C.PIPE_CASES))
def test_executor_matches_reference(results, cid):
    """The port's executor against the live JAX executor on the same
    parameters and microbatches, and against the port's single-device
    forward; every rank of the mesh returns the same loss."""
    ranks, jax_out = results
    got = ranks[0][cid]
    want = {k[len(cid) + 6:]: v for k, v in jax_out.items()
            if k.startswith(f"{cid}/grad/")}
    _assert_close(got["loss"], got["grads"], float(jax_out[f"{cid}/loss"]),
                  want, f"{cid} vs JAX")
    _assert_close(got["loss"], got["grads"], got["ref_loss"],
                  got["ref_grads"], f"{cid} vs single device")
    n = 8 if C.PIPE_CASES[cid][0] == "4x2" else 2
    assert {r[cid]["loss"] for r in ranks[:n]} == {got["loss"]}
    assert all(cid not in r for r in ranks[n:])
