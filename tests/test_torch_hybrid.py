"""The port's hybrid DP x pipe x TP step (``train/step.py::
build_hybrid_{value_and_grad,train_step}``) against the JAX package, on one
pool of 8 gloo ranks beside a child interpreter with 8 host devices
(``torch_pipeline_jax.py hybrid``) that runs the live reference executor on
the same carried-over parameters and data.

- (dp, S, tp) = (2, 2, 2) with 1F1B and fill-drain, and (4, 2, 1) without
  explicit TP: the loss (rtol 2e-5) and every grad leaf (rtol, atol 5e-4)
  of the JAX executor and of the port's own single-device forward
  (tests/md/test_hybrid.py's pins).
- dp = 1 on the 3-D mesh equals the 2-D pipeline mesh (rtol 1e-6, atol
  1e-7); (dp, 1, tp) = (2, 1, 4) equals a plain DP x TP program with
  autograd through the microbatch loop (rtol 2e-5 loss, 5e-5 / 5e-6
  grads), as tests/md/test_hybrid.py holds the reference.
- two AdamW steps of ``build_hybrid_train_step`` on (2, 2, 2) against the
  reference's step: losses, grad norms and every parameter; the state is
  per rank (each rank holds its stage's blocks and TP shard).
- ``virtual_dp = 2`` at dp = 1 against dp = 2: the executor's loss and
  grads bitwise (DESIGN §10), and the state after a step.
- the guard: a NaN on one rank skips the step on every rank, params and
  moments bitwise unchanged; the guarded step makes exactly one more
  ``torch.distributed.all_reduce`` than the unguarded one.
- a fault that one rank alone sees outside the step (an ``OSError`` in a
  save, in the reference's recoverable set) is carried to every rank by
  the guard's all-reduce and restarts the whole mesh from the newest
  checkpoint, bitwise the fault-free run; a fault outside the set ends
  the run on every rank.
- the CLI's ``--device cpu --hybrid-mesh 2,2,1,2,1`` run (its own 8
  spawned ranks), reduced jamba at ``2,1,1,1,4`` and reduced llama4 at
  ``1,1,1,2,4`` (MoE over a live ep axis), and its exits for a sequence
  CP does not divide, SSM mixers under CP > 1 and tied embeddings.
"""

import functools
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_pipeline_cases as C
import torch_region_cases as RC
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.core import linop
from repro_torch.core import primitives as prim
from repro_torch.core.compile import dist_jit, resolve_parts
from repro_torch.core.linop import PartitionSpec as P
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import (from_pipeline_params, pipeline_fns,
                                pipeline_param_parts, to_pipeline_params)
from repro_torch.models.convert import params_from_jax, to_rank_params
from repro_torch.optim import make_optimizer
from repro_torch.sharding import Partitioned, Policy
from repro_torch.train import (build_hybrid_train_step,
                               build_hybrid_value_and_grad, build_loss_fn,
                               cross_entropy, init_train_state)
from repro_torch.tree import tree_leaves

CFG = ModelConfig(**C.CFG)
POOL_TIMEOUT_S = 600
M = C.HYBRID_M
POISONED = 5          # the one rank whose gradients the fault hook poisons


def _data(init):
    tokens = torch.from_numpy(init[f"data/M{M}/tokens"]).long()
    labels = torch.from_numpy(init[f"data/M{M}/labels"]).long()
    return tokens, labels


def _single_device(pparams, tokens, labels):
    loss_fn = build_loss_fn(CFG)
    dense = {k: v.clone().requires_grad_() for k, v in
             from_pipeline_params(pparams).items()}
    n = tokens.shape[0]
    tot = sum(loss_fn(dense, {"tokens": tokens[m], "labels": labels[m]})[0]
              for m in range(n)) / n
    grads = torch.autograd.grad(tot, list(dense.values()))
    S = pparams["stage.pos0.attn.wq"].shape[0]
    return float(tot), to_pipeline_params(CFG, dict(zip(dense, grads)), S)


def _pvg(mesh, schedule, explicit, pparams, tokens, labels, **kw):
    pol = Policy.for_mesh(mesh, explicit_tp=explicit)
    pvg, _ = build_hybrid_value_and_grad(CFG, pol, num_microbatches=M,
                                         schedule=schedule, **kw)
    return pvg(pparams, {"tokens": tokens}, labels)


def _gather(policy, params):
    """The global params of this rank's blocks (every rank of the mesh)."""
    specs = resolve_parts(pipeline_param_parts(CFG, policy, params), policy)
    return {k: linop.assemble(v, specs[k], policy.mesh)
            for k, v in params.items()}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


def _step_state(pol, p2, opt, **kw):
    step = build_hybrid_train_step(CFG, pol, opt, num_microbatches=M, **kw)
    return step, init_train_state(CFG, to_rank_params(CFG, pol, p2), opt)


def _dp_tp_program(mesh, pparams, tokens, labels):
    """tests/md/test_hybrid.py::test_s1_reduces_to_pure_dp_tp: the same
    model as one region with autograd end to end through the microbatch
    loop, the DP mean and the contribution-form model-axis sum of the
    feature-sliced prologue written out by hand."""
    pol = Policy.for_mesh(mesh, explicit_tp=True)
    pre_fn, stage_fn, logits_fn = pipeline_fns(CFG, pol)
    n = tokens.shape[0]

    def body(params, xs, ys):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        pre = {k[4:]: v for k, v in leaves.items() if k.startswith("pre.")}
        post = {k[5:]: v for k, v in leaves.items() if k.startswith("post.")}
        stage = {k[6:]: v[0] for k, v in leaves.items()
                 if k.startswith("stage.")}
        tot = sum(cross_entropy(logits_fn(post, stage_fn(
            stage, pre_fn(pre, {"tokens": xs["tokens"][m]}))), ys[m])[0]
            for m in range(n)) / n
        grads = dict(zip(leaves, torch.autograd.grad(tot,
                                                     list(leaves.values()))))
        dp = pol.axis_size(pol.data_axis)
        with torch.no_grad():
            for k, g in grads.items():
                axes = [pol.data_axis]
                if k.startswith("pre."):
                    axes.append(pol.model_axis)
                prim.psum_([g], axes)
                g.div_(dp)
            loss = tot.detach()
            prim.psum_([loss], [pol.data_axis])
        return loss / dp, grads

    mb = Partitioned(None, "data")
    parts = pipeline_param_parts(CFG, pol, pparams)
    return dist_jit(body, pol, (parts, {"tokens": mb}, mb),
                    (P(), parts))(pparams, {"tokens": tokens}, labels)


def _rank_fn(rank, mesh1d, init):
    out = {}
    p2 = params_from_jax(C.subtree(init, "p2"))
    tokens, labels = _data(init)
    meshes = {}
    # --- the JAX parity cases (8 ranks each)
    for cid, (shape, schedule, explicit) in C.HYBRID_CASES.items():
        if shape not in meshes:
            meshes[shape] = tmesh.make_hybrid_mesh(shape[0], shape[1],
                                                   tp=shape[2], device="cpu")
        loss, grads = _pvg(meshes[shape], schedule, explicit, p2, tokens,
                           labels)
        out[cid] = {"loss": float(loss)}
        if rank == 0:
            ref_loss, ref_grads = _single_device(p2, tokens, labels)
            out[cid].update(grads=grads, ref_loss=ref_loss,
                            ref_grads=ref_grads)
    m222 = meshes[(2, 2, 2)]
    # --- dp = 1 on the 3-D mesh vs the 2-D pipeline mesh (ranks 0-3)
    m122 = tmesh.make_hybrid_mesh(1, 2, tp=2, device="cpu")
    m22 = tmesh.make_pipeline_mesh(2, 2, device="cpu")
    if m122 is not None:
        out["dp1"] = [_pvg(m, "1f1b", True, p2, tokens, labels)
                      for m in (m122, m22)]
    # --- (dp, 1, tp) = (2, 1, 4) vs the plain DP x TP program, M = 2
    m214 = tmesh.make_hybrid_mesh(2, 1, tp=4, device="cpu")
    p1 = to_pipeline_params(CFG, from_pipeline_params(p2), 1)
    t8 = tokens.reshape(-1, C.SEQ)[:8].reshape(2, 4, C.SEQ)
    l8 = labels.reshape(-1, C.SEQ)[:8].reshape(2, 4, C.SEQ)
    pol214 = Policy.for_mesh(m214, explicit_tp=True)
    pvg, _ = build_hybrid_value_and_grad(CFG, pol214, num_microbatches=2)
    out["s1"] = [pvg(p1, {"tokens": t8}, l8),
                 _dp_tp_program(m214, p1, t8, l8)]
    # --- two AdamW steps on (2, 2, 2) against the reference's step
    pol = Policy.for_mesh(m222, explicit_tp=True)
    opt = make_optimizer("adamw", total_steps=10)
    step, state = _step_state(pol, p2, opt)
    mine = sum(v.numel() for v in state["params"].values())
    batch = {"tokens": init["train/tokens"], "labels": init["train/labels"]}
    mets = []
    for _ in range(C.TRAIN_STEPS):
        state, met = step(state, batch)
        mets.append({k: float(v) for k, v in met.items()})
    out["train"] = {"metrics": mets, "rank_numel": mine,
                    "global_numel": sum(v.numel() for v in p2.values()),
                    "step": state["step"]}
    final = _gather(pol, state["params"])
    if rank == 0:
        out["train"]["params"] = final
    # --- virtual_dp = 2 at dp = 1 vs dp = 2, without and with clipping
    out["vdp"] = {}
    pol122 = (Policy.for_mesh(m122, explicit_tp=True) if m122 is not None
              else None)
    for clip in (1e9, 1.0):
        pvg2, _ = build_hybrid_value_and_grad(CFG, pol, num_microbatches=M)
        full = pvg2(p2, {"tokens": tokens}, labels)
        s_full, st_full = _step_state(pol, p2, opt, max_grad_norm=clip)
        st_full, met_full = s_full(st_full, batch)
        if pol122 is not None:
            s_v, st_v = _step_state(pol122, p2, opt, max_grad_norm=clip,
                                    virtual_dp=2)
            st_v, met_v = s_v(st_v, batch)
            # the executor's own passes, combined as the step combines them
            pvg1, _ = build_hybrid_value_and_grad(CFG, pol122,
                                                  num_microbatches=M)
            half = tokens.shape[1] // 2
            passes = [pvg1(p2, {"tokens": tokens[:, v * half:(v + 1) * half]},
                           labels[:, v * half:(v + 1) * half])
                      for v in range(2)]
            out["vdp"][clip] = {
                "loss": [full[0], sum(p[0] for p in passes) / 2],
                "grads_equal": all(torch.equal(
                    full[1][k], sum(p[1][k] for p in passes) / 2)
                    for k in full[1]),
                "params_equal": _equal(st_full["params"], st_v["params"]),
                "params_err": max(float((st_full["params"][k]
                                         - st_v["params"][k]).abs().max())
                                  for k in st_v["params"]),
                "grad_norm": [float(met_full["grad_norm"]),
                              float(met_v["grad_norm"])]}
    # --- the guard on (2, 2, 2): a NaN on one rank skips everywhere
    def poison(grads):
        if dist.get_rank() != POISONED:
            return grads
        k = "stage.pos0.mlp.w_up"
        return dict(grads, **{k: grads[k] + float("nan")})

    guarded, state = _step_state(pol, p2, opt, fault_hook=poison)
    before = _clone({"params": state["params"], "opt": state["opt"]})
    state, met = guarded(state, batch)
    out["guard"] = {
        "skipped": int(met["skipped"]), "step": state["step"],
        "skipped_steps": state["skipped_steps"],
        "params_equal": _equal(state["params"], before["params"]),
        "moments_equal": all(_equal(state["opt"][m], before["opt"][m])
                             for m in ("m", "v")),
        "count": state["opt"]["count"]}
    # --- the guard's cost: exactly one more all_reduce
    calls = {"n": 0}
    real = dist.all_reduce

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    counts = {}
    for guard in (True, False):
        step_g, st = _step_state(pol, p2, opt, nonfinite_guard=guard)
        dist.all_reduce = counting
        try:
            calls["n"] = 0
            step_g(st, batch)
            counts[guard] = calls["n"]
        finally:
            dist.all_reduce = real
    out["all_reduce_calls"] = counts
    # --- the layout of gathered and scattered results: contiguous, as the
    # card's kernels take them (the epilogue's feature gather feeds the
    # final norm's kernel)
    with prim.use_mesh(m222):
        x = torch.randn(4, 6, 8)
        out["contiguous"] = {
            f"{name} dim {d}": fn(x, "model", d).is_contiguous()
            for d in range(3)
            for name, fn in (("all_gather", prim.all_gather),
                             ("all_gather_replicated",
                              prim.all_gather_replicated),
                             ("reduce_scatter", prim.reduce_scatter))}
    # --- the executor's phase hook: one call a tick, then drain, optimizer
    kinds = []
    hooked, st = _step_state(pol, p2, opt, phase_hook=kinds.append)
    hooked(st, batch)
    out["phase_hook"] = kinds
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "hybrid.npz"
    child = C.start_jax("hybrid", path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, jax_out


def _assert_close(loss, grads, want_loss, want_grads, what, *,
                  loss_rtol=C.LOSS_RTOL, rtol=C.GRAD_TOL, atol=C.GRAD_TOL):
    np.testing.assert_allclose(loss, want_loss, rtol=loss_rtol,
                               err_msg=f"{what} loss")
    assert set(grads) == set(want_grads), what
    for k, g in grads.items():
        np.testing.assert_allclose(np.asarray(g), np.asarray(want_grads[k]),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} grad {k}")


@pytest.mark.parametrize("cid", list(C.HYBRID_CASES))
def test_hybrid_matches_reference(results, cid):
    """(2, 2, 2) 1F1B and fill-drain, (4, 2, 1): the port's executor
    against the live JAX executor and the port's single-device forward;
    the loss is the same on every rank."""
    ranks, jax_out = results
    got = ranks[0][cid]
    want = {k[len(cid) + 6:]: v for k, v in jax_out.items()
            if k.startswith(f"{cid}/grad/")}
    _assert_close(got["loss"], got["grads"], float(jax_out[f"{cid}/loss"]),
                  want, f"{cid} vs JAX")
    _assert_close(got["loss"], got["grads"], got["ref_loss"],
                  got["ref_grads"], f"{cid} vs single device")
    assert {r[cid]["loss"] for r in ranks} == {got["loss"]}


def test_dp1_equals_pipeline_mesh(results):
    ranks = results[0]
    for r in range(4):
        (l3, g3), (l2, g2) = ranks[r]["dp1"]
        _assert_close(float(l3), g3, float(l2), g2, f"rank {r}",
                      loss_rtol=1e-6, rtol=1e-6, atol=1e-7)
    assert all("dp1" not in r for r in ranks[4:])


def test_single_stage_reduces_to_plain_dp_tp(results):
    for r, rank in enumerate(results[0]):
        (loss, grads), (ref_loss, ref_grads) = rank["s1"]
        _assert_close(float(loss), grads, float(ref_loss), ref_grads,
                      f"rank {r}", rtol=5e-5, atol=5e-6)


def test_two_adamw_steps_match_reference(results):
    """The same batch twice through the port's per-rank step and the
    reference's jitted step: losses, grad norms, every parameter after the
    two updates (the reference's pins), and the loss falls."""
    ranks, jax_out = results
    got = ranks[0]["train"]
    for i, met in enumerate(got["metrics"]):
        np.testing.assert_allclose(met["loss"],
                                   float(jax_out[f"train/loss{i}"]),
                                   rtol=C.LOSS_RTOL)
        np.testing.assert_allclose(met["grad_norm"],
                                   float(jax_out[f"train/grad_norm{i}"]),
                                   rtol=C.GRAD_TOL)
        assert met["bubble_fraction"] == pytest.approx(1 / 5)   # S 2, M 4
        assert met["skipped"] == 0
    assert got["metrics"][1]["loss"] < got["metrics"][0]["loss"]
    for k, v in got["params"].items():
        np.testing.assert_allclose(v, jax_out[f"train/params/{k}"],
                                   rtol=C.GRAD_TOL, atol=C.GRAD_TOL,
                                   err_msg=k)
    assert got["step"] == 2
    for r, rank in enumerate(ranks):
        assert rank["train"]["metrics"] == got["metrics"], r


def test_state_is_per_rank(results):
    """Each rank holds only its stage's blocks and its TP shard: on
    (2, 2, 2) a quarter of the stage leaves (pipe 2 x model 2) and the
    whole pre/post leaves."""
    got = results[0][0]["train"]
    p2 = {k: v for k, v in got["params"].items()}
    pre_post = sum(math.prod(v.shape) for k, v in p2.items()
                   if not k.startswith("stage."))
    stage = sum(math.prod(v.shape) for k, v in p2.items()
                if k.startswith("stage."))
    assert got["global_numel"] == pre_post + stage
    for rank in results[0]:
        assert rank["train"]["rank_numel"] == pre_post + stage // 4


@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_virtual_dp_matches_wider_mesh(results, clip):
    """(1, 2, 2) with virtual_dp = 2 against (2, 2, 2): the executor's
    passes combine to the wider mesh's loss and grads bitwise, and the
    state after one step is bitwise equal with and without clipping (the
    clip norm sums over one data replica, the same ranks in the same
    order on both meshes)."""
    for r in range(4):
        got = results[0][r]["vdp"][clip]
        assert got["loss"][0] == got["loss"][1], (r, got["loss"])
        assert got["grads_equal"], r
        assert got["grad_norm"][0] == got["grad_norm"][1], (r, got)
        assert got["params_equal"], (r, got["params_err"])


def test_nan_on_one_rank_skips_everywhere(results):
    for r, rank in enumerate(results[0]):
        got = rank["guard"]
        assert got["skipped"] == 1, r
        assert got["params_equal"] and got["moments_equal"], r
        assert (got["step"], got["skipped_steps"], got["count"]) == (1, 1, 0)


def test_guard_costs_exactly_one_all_reduce(results):
    for r, rank in enumerate(results[0]):
        calls = rank["all_reduce_calls"]
        assert calls[True] == calls[False] + 1, (r, calls)


def test_gathers_return_contiguous_tensors(results):
    """A gathered or scattered result along any dim is a fresh contiguous
    tensor, as a JAX array is: the RMSNorm kernel refuses a permuted view,
    which the host's plain version would take (the epilogue's feature
    gather under explicit TP feeds it on the card)."""
    for r, rank in enumerate(results[0]):
        assert all(rank["contiguous"].values()), (r, rank["contiguous"])


def test_phase_hook_sees_every_tick(results):
    """The instrumentation point chip_smoke.py splits a step at: each rank
    reports its own F, B and idle slots (the schedule's column for its
    stage), each followed by ``boundary`` where the global tables say
    something crosses a stage boundary on that tick, then the drain and
    the optimizer, once each."""
    from repro_torch.core.pipeline import make_schedule
    sched = make_schedule("1f1b", M, 2)
    crosses = ((sched.ops[:, :-1] == 1).any(axis=1)
               | (sched.ops[:, 1:] == 2).any(axis=1))
    assert crosses.any() and not crosses.all()
    for r, rank in enumerate(results[0]):
        stage = (r // 2) % 2          # (data, pipe, model) = (2, 2, 2)
        want = []
        for t, op in enumerate(sched.ops[:, stage]):
            want.append(("idle", "F", "B")[op])
            if crosses[t]:
                want.append("boundary")
        assert rank["phase_hook"] == want + ["drain", "optimizer"], r


def test_hybrid_cli_on_the_host(capsys):
    """The CLI spawns 8 gloo ranks over (data, pipe, model) = (2, 2, 2)."""
    _, hist = launch_train.main([
        "--reduced", "--device", "cpu", "--hybrid-mesh", "2,2,1,2,1",
        "--microbatches", "2", "--steps", "2", "--batch", "8", "--seq",
        "16"])
    out = capsys.readouterr().out
    assert "done: final loss" in out and "8 ranks" in out
    assert "skipped_steps=0" in out
    assert len(hist) == 2
    assert all(np.isfinite(rec["loss"]) and rec["skipped"] == 0
               for rec in hist)
    assert hist[0]["bubble_fraction"] == pytest.approx(1 / 3)   # S 2, M 2


FAULTY = 3            # the one rank whose save raises in the fault tests
FAULT_CASES = ("save", "write")


def _failing_saves(rank, case, exc):
    """Patch this spawned process's checkpoint saves so that the save of
    step 2 (after step 1) fails once: ``save`` on rank ``FAULTY``, after
    its part of the save's collectives; ``write`` in the writer's (rank
    0's) background write.  Returns the undo."""
    real_async, real_write = ckpt_lib.save_async, ckpt_lib._write
    fired = []

    def save_async(ckpt_dir, step, *a, **kw):
        out = real_async(ckpt_dir, step, *a, **kw)
        if step == 2 and not fired:
            fired.append(step)
            raise exc
        return out

    def write(ckpt_dir, step, *a, **kw):
        if step == 2 and not fired:
            fired.append(step)
            raise exc
        return real_write(ckpt_dir, step, *a, **kw)

    if case == "save" and rank == FAULTY:
        ckpt_lib.save_async = save_async
    if case == "write" and rank == 0:
        ckpt_lib._write = write

    def undo():
        ckpt_lib.save_async, ckpt_lib._write = real_async, real_write
    return undo


def _train_faulty(tag, d, logs=None):
    state, hist, _ = launch_train.train_hybrid_rank(
        reduced(get_config("glm4-9b")), (1, 2, 1, 2, 1), steps=3, batch=4,
        seq=16, microbatches=2, device="cpu", ckpt_dir=f"{d}/{tag}",
        ckpt_every=1, logger=(logs.append if logs is not None
                              else lambda line: None))
    return state, hist


def _fault_runs(rank, world_mesh, *, d):
    """The CLI's per-rank path on (data, pipe, model) = (1, 2, 2) with a
    checkpoint every step, in one world: without a fault, then with an
    ``OSError`` in the save of step 2 on one rank for each case of
    :data:`FAULT_CASES`."""
    out = {}
    clean, hist = _train_faulty("clean", d)
    out["clean"] = [rec["loss"] for rec in hist]
    for case in FAULT_CASES:
        undo = _failing_saves(rank, case,
                              OSError(f"injected {case} failure"))
        logs = []
        healed, hist = _train_faulty(case, d, logs)
        undo()
        out[case] = {"records": [(rec["step"], rec["loss"])
                                 for rec in hist],
                     "failures": [line for line in logs
                                  if line.startswith("failure")],
                     "health": hist.health,
                     "equal": all(
                         torch.equal(a, b) if isinstance(a, torch.Tensor)
                         else a == b for a, b in zip(tree_leaves(healed),
                                                     tree_leaves(clean)))}
    return out


@pytest.fixture(scope="module")
def fault_runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("faults"))
    return tmesh.spawn(functools.partial(_fault_runs, d=d), 4, device="cpu",
                       timeout_s=300)


@pytest.mark.parametrize("case", FAULT_CASES)
def test_fault_on_one_rank_restarts_the_whole_mesh(fault_runs, case):
    """An ``OSError`` (the reference's recoverable set) in one rank's save
    of step 2 (``save``: rank FAULTY; ``write``: the writer's background
    write) heals: the next step's guard all-reduce (or the loop's closing
    agreement) carries it to every rank, every rank restarts once from
    the newest verified checkpoint, and every rank's losses (each step's,
    replays included) and final state are bitwise the fault-free run's.
    Which checkpoint is newest depends on when the write failure is seen,
    so the replayed steps may differ between runs."""
    for r, rank in enumerate(fault_runs):
        got = rank[case]
        assert {s for s, _ in got["records"]} == {0, 1, 2}, (r, got)
        for step, loss in got["records"]:
            assert loss == rank["clean"][step], (r, step, got, rank["clean"])
        assert got["equal"], f"rank {r}: final state differs"
        assert got["health"]["restarts"] == 1, (r, got["health"])
        if case == "save":    # held after step 1, agreed by step 2's guard
            assert "at step 2)" in got["failures"][0], (r, got["failures"])


def _fatal_fault(rank, world_mesh, *, d):
    _failing_saves(rank, "save", KeyError("outside the recoverable set"))
    _train_faulty("keyerror", d)
    return rank


def test_fault_outside_the_set_ends_the_run(tmp_path):
    """A ``KeyError`` in one rank's save is not restarted: it ends the run
    on every rank (``launch.mesh.spawn`` stops the pool)."""
    with pytest.raises(RuntimeError,
                       match=rf"rank {FAULTY} failed:(.|\n)*KeyError"):
        tmesh.spawn(functools.partial(_fatal_fault, d=str(tmp_path)), 4,
                    device="cpu", timeout_s=300)


@pytest.mark.parametrize("arch,mesh", [
    ("jamba-v0.1-52b", "2,1,1,1,4"),        # SSM mixers, MoE, no TP
    ("llama4-maverick-400b-a17b", "1,1,1,2,4"),   # explicit TP beside EP
])
def test_hybrid_cli_runs_moe_on_the_host(capsys, arch, mesh):
    """MoE archs through the CLI on 8 gloo ranks with a live ep axis:
    (dp, ep) = (2, 4), and (tp, ep) = (2, 4) with explicit TP (which takes
    MoE behind attention mixers only, so not jamba's)."""
    _, hist = launch_train.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--hybrid-mesh",
        mesh, "--microbatches", "2", "--steps", "2", "--batch", "16",
        "--seq", "16"])
    out = capsys.readouterr().out
    assert "done: final loss" in out and "8 ranks" in out
    assert "skipped_steps=0" in out and "'ep': 4" in out
    assert len(hist) == 2
    assert all(np.isfinite(rec["loss"]) and rec["skipped"] == 0
               for rec in hist)


@pytest.mark.parametrize("argv,match", [
    (["--hybrid-mesh", "1,1,3,1", "--seq", "16"], "not divisible by CP=3"),
    (["--arch", "jamba-v0.1-52b", "--hybrid-mesh", "1,1,2,1,2"],
     "zero state"),
    (["--hybrid-mesh", "1,2"], "DP,PP,CP,TP,EP"),
])
def test_hybrid_cli_exits_naming_the_item(argv, match):
    with pytest.raises(SystemExit, match=match):
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1"]
                          + argv)


@pytest.mark.parametrize("arch", ["mamba2-370m", "phi4-mini-3.8b"])
def test_tied_embedding_archs_refused(arch):
    with pytest.raises(NotImplementedError, match="untied"):
        launch_train.check_hybrid(reduced(get_config(arch)), (1, 1, 1, 1, 1))


def test_batch_not_divisible_raises():
    """The step's divisibility contract, on a one-rank (1, 1, 1) world."""
    pol = Policy(mesh=_FakeMesh(), pipe_axis="pipe")
    opt = make_optimizer("adamw", total_steps=10)
    step = build_hybrid_train_step(CFG, pol, opt, num_microbatches=4)
    bad = {"tokens": np.zeros((6, 16), np.int32),
           "labels": np.zeros((6, 16), np.int32)}
    state = {"params": {"pre.embed": torch.zeros(1)}}
    with pytest.raises(ValueError, match="not divisible"):
        step(state, bad)


class _FakeMesh:
    """A (data, pipe, model) = (1, 1, 1) shape without a process group:
    the step refuses the batch before any communication."""

    mesh_dim_names = ("data", "pipe", "model")

    def size(self, i):
        return 1

