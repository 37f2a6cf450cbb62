"""Checkpoints, self-healing and elastic recovery on the port's hybrid mesh,
on one pool of 8 gloo ranks (the multi-device cases of
``tests/md/test_ckpt_distributed.py``, ``tests/md/test_resilience_md.py``
and ``tests/md/test_elastic_md.py``).

- Sharded round trips at (dp, S, tp) = (2, 2, 2) and on the pipeline mesh
  (4, 2): a step taken from the restored state is bitwise the step of the
  uninterrupted run, and each rank gets back exactly the blocks it held.
- The chaos run at (dp, pp, cp, tp) = (2, 1, 2, 2), a checkpoint every 2
  steps: NaN poison at step 3 (skipped on every rank), a crash at 5 that
  bit-flips the newest checkpoint (step 4, which holds the skip) on rank
  0, the agreed quarantine and fallback to step 2, the replay: final
  loss and every parameter and moment bitwise the fault-free run's.
- A (2, 1, 2, 2) checkpoint resharded onto ONE rank continues the run: its
  next loss is the full mesh's within 1e-5.
- The elastic shrink (2, 1, 2, 2) -> (1, 1, 2, 2) at step 3, virtual_dp 2:
  the lost data replica's ranks leave before the survivors' first
  collective on the re-formed world, and the survivors end bitwise equal
  to the full mesh's fault-free run.
- The CLI: ``--hybrid-mesh 2,1,2,2 --fault-plan shrink=3:data --elastic``
  ends on the clean run's final loss, to the last bit.
"""

import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import ModelConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import init_pipeline_params
from repro_torch.models.convert import to_rank_params
from repro_torch.optim import make_optimizer
from repro_torch.resilience import (DeviceLossError, FaultInjector,
                                    FaultPlan, InjectedCrash, nan_grad_hook)
from repro_torch.sharding import Policy
from repro_torch.train import (LoopConfig, build_hybrid_train_step,
                               elastic_restart_on_failure,
                               hybrid_param_parts, init_train_state,
                               restart_on_failure, run)

CK = ModelConfig(name="ck_test", family="dense", num_layers=4, d_model=64,
                 num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
                 vocab_size=128, dtype="float32", remat=False, attn_chunk=16)
CFG = ModelConfig(name="resil", family="dense", num_layers=4, d_model=64,
                  num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
                  vocab_size=256, dtype="float32", remat=False,
                  attn_chunk=16)
TOTAL = 8
FULL = (2, 1, 2, 2, 1)                     # (dp, S, cp, tp, ep)
M = 4


def _batch(i, vocab=CFG.vocab_size):
    g = torch.Generator().manual_seed(1000 + i)
    return {"tokens": torch.randint(0, vocab, (16, 16), generator=g),
            "labels": torch.randint(0, vocab, (16, 16), generator=g)}


class _It:
    def __init__(self, start):
        self.s = start

    def __next__(self):
        s = self.s
        self.s += 1
        return s, _batch(s)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _setup(cfg, fact, vdp, opt, hook=None):
    """``(policy, parts, make_state, step, poisoned)`` on ``fact``: the
    elastic supervisor's ``make_setup`` contract."""
    mesh = tmesh.make_hybrid_mesh(*fact, device="cpu")
    pol = Policy.for_mesh(mesh, explicit_tp=True)
    kw = dict(num_microbatches=M, schedule="1f1b", virtual_dp=vdp)
    glob = init_pipeline_params(cfg, torch.Generator().manual_seed(0),
                                pol.pipe_size, "cpu")

    def make_state():
        return init_train_state(cfg, to_rank_params(cfg, pol, glob), opt)

    return (pol, hybrid_param_parts(cfg, pol), make_state,
            build_hybrid_train_step(cfg, pol, opt, **kw),
            build_hybrid_train_step(cfg, pol, opt, fault_hook=hook, **kw)
            if hook else None)


def _roundtrip(pol, d):
    """tests/md/test_ckpt_distributed.py::_roundtrip on this rank."""
    opt = make_optimizer("adamw", total_steps=10)
    step = build_hybrid_train_step(CK, pol, opt, num_microbatches=M)
    parts = hybrid_param_parts(CK, pol)
    glob = init_pipeline_params(CK, torch.Generator().manual_seed(0),
                                pol.pipe_size, "cpu")
    batch = _batch(7, CK.vocab_size)
    state, _ = step(init_train_state(CK, to_rank_params(CK, pol, glob), opt),
                    batch)
    ckpt_lib.save(d, 1, state, policy=pol, parts=parts)
    saved = _clone(state)
    cont, met = step(state, batch)
    like = init_train_state(CK, to_rank_params(CK, pol, glob), opt)
    restored, at = ckpt_lib.restore(d, like=like, policy=pol, parts=parts)
    held = _equal(restored, saved)
    resumed, rmet = step(restored, batch)
    return {"step": at, "held": held, "resumed": _equal(resumed, cont),
            "loss": [float(met["loss"]), float(rmet["loss"])]}


def _rank_fn(rank, mesh1d, *, d):
    out = {}
    # --- sharded round trips
    pol = Policy.for_mesh(tmesh.make_hybrid_mesh(2, 2, tp=2, device="cpu"),
                          explicit_tp=True)
    out["rt222"] = _roundtrip(pol, f"{d}/rt222")
    pol = Policy.for_mesh(tmesh.make_pipeline_mesh(4, 2, device="cpu"),
                          explicit_tp=True)
    out["rt42"] = _roundtrip(pol, f"{d}/rt42")

    # --- the chaos run and its fault-free golden on (2, 1, 2, 2)
    opt = make_optimizer("adamw", total_steps=TOTAL)
    pol, parts, make_state, step, poisoned = _setup(CFG, FULL, 1, opt,
                                                    nan_grad_hook())
    golden, ghist = run(make_state(), step, _It(0),
                        LoopConfig(total_steps=TOTAL, log_every=1000),
                        logger=lambda *a: None)
    plan = FaultPlan.parse("poison=3,crash=5,corrupt=bitflip")
    inj = FaultInjector(plan, step, poisoned_step_fn=poisoned,
                        ckpt_dir=f"{d}/chaos", corrupt_rank=rank == 0)
    state, hist = restart_on_failure(
        make_state, inj, _It, LoopConfig(total_steps=TOTAL,
                                         ckpt_dir=f"{d}/chaos",
                                         ckpt_every=2, keep=5,
                                         log_every=1000),
        policy=pol, parts=parts, recoverable=(InjectedCrash, DeviceLossError),
        backoff_base=0.01, logger=lambda *a: None)
    out["chaos"] = {"loss": [hist[-1]["loss"], ghist[-1]["loss"]],
                    "equal": _equal(state, golden), "health": hist.health,
                    "steps": [r["step"] for r in hist]}
    state = None

    # --- a (2, 1, 2, 2) checkpoint resharded onto one rank
    s1, _ = step(make_state(), _batch(0))
    ckpt_lib.save(f"{d}/cross", 1, s1, policy=pol, parts=parts)
    _, m_full = step(s1, _batch(1))
    one = tmesh.make_hybrid_mesh(1, 1, 1, 1, device="cpu")
    if one is not None:
        pol1 = Policy.for_mesh(one, explicit_tp=True)
        step1 = build_hybrid_train_step(CFG, pol1, opt, num_microbatches=M)
        glob = init_pipeline_params(CFG, torch.Generator().manual_seed(0),
                                    1, "cpu")
        like = init_train_state(CFG, glob, opt)
        plans = ckpt_lib.plan_reshard(f"{d}/cross", None, like=like)
        restored, got = ckpt_lib.restore_resharded(f"{d}/cross", None,
                                                   like=like)
        _, m_one = step1(restored, _batch(1))
        out["cross"] = {"step": got, "loss": [float(m_full["loss"]),
                                              float(m_one["loss"])],
                        "srcs": sorted({str(p.src) for p in plans})}

    # --- the elastic shrink, last: it re-forms the world without 4-7
    gold = {"loss": ghist[-1]["loss"], "state": golden}
    logs = []
    inj = FaultInjector(FaultPlan.parse("shrink=3:data"), None)
    state, hist = elastic_restart_on_failure(
        lambda fact, devices, vdp: _setup(CFG, fact, vdp, opt), _It,
        LoopConfig(total_steps=TOTAL, ckpt_dir=f"{d}/elastic", ckpt_every=2,
                   keep=5, log_every=1000),
        factorization=FULL, injector=inj, backoff_base=0.01,
        logger=lambda line: logs.append((time.time(), line)))
    left = [t for t, line in logs if "leaving the mesh" in line]
    shrunk = [t for t, line in logs if "shrinking to" in line]
    out["elastic"] = {"left": state is None, "t_left": left,
                      "t_shrunk": shrunk, "health": hist.health}
    if state is not None:
        out["elastic"].update(
            loss=[hist[-1]["loss"], gold["loss"]],
            equal=_equal(state["params"], gold["state"]["params"]),
            world=dist.get_world_size(), steps=[r["step"] for r in hist])
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    return tmesh.spawn(functools.partial(_rank_fn, d=d), 8, device="cpu",
                       timeout_s=600)


@pytest.mark.parametrize("case", ["rt222", "rt42"])
def test_sharded_roundtrip_bitwise(ranks, case):
    for r, rank in enumerate(ranks):
        got = rank[case]
        assert got["step"] == 1, r
        assert got["held"], f"rank {r}: restored blocks differ"
        assert got["resumed"], f"rank {r}: the resumed step differs"
        assert got["loss"][0] == got["loss"][1], r


def test_chaos_hybrid_self_heals_to_exact_golden(ranks):
    for r, rank in enumerate(ranks):
        got = rank["chaos"]
        assert got["loss"][0] == got["loss"][1], (r, got["loss"])
        assert got["equal"], f"rank {r}: state differs from the golden run"
        h = got["health"]
        assert (h["restarts"], h["skipped_steps"],
                h["quarantined_checkpoints"]) == (1, 1, 1), (r, h)
        assert got["steps"] == list(range(5)) + list(range(2, TOTAL)), r


def test_cross_mesh_restore_continues_the_run(ranks):
    got = ranks[0]["cross"]
    assert got["step"] == 1
    np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=1e-5)
    # replicated leaves, and stage leaves split over pipe and model (two
    # named axes: the plan routes them through the replicated space)
    assert got["srcs"] == ["Layout(axis=None, dim=0)", "None"]
    assert all("cross" not in rank for rank in ranks[1:])


def test_elastic_shrink_is_bitwise_the_full_mesh(ranks):
    lost = [r for r, rank in enumerate(ranks) if rank["elastic"]["left"]]
    assert lost == [4, 5, 6, 7]
    first_collective = min(t for rank in ranks[:4]
                           for t in rank["elastic"]["t_shrunk"])
    assert max(t for r in lost for t in ranks[r]["elastic"]["t_left"]) \
        < first_collective
    for r, rank in enumerate(ranks[:4]):
        got = rank["elastic"]
        assert got["world"] == 4, r
        assert got["loss"][0] == got["loss"][1], (r, got["loss"])
        assert got["equal"], f"rank {r}: params differ from the full mesh"
        assert got["health"]["mesh_shrinks"] == 1, r
        assert got["steps"] == list(range(3)) + list(range(2, TOTAL)), r


def test_device_loss_is_not_retried_as_plain_restart():
    """The injector's DeviceLossError carries the lost axis, the elastic
    supervisor's dispatch key, and fires once."""
    calls = []
    inj = FaultInjector(FaultPlan.parse("shrink=2:ctx"),
                        lambda s, b: calls.append(s) or (s, {}))
    with pytest.raises(DeviceLossError) as ei:
        inj({"step": 2}, {})
    assert ei.value.axis == "ctx" and ei.value.step == 2
    inj({"step": 2}, {})
    assert len(calls) == 1


def test_elastic_cli_ends_on_the_clean_loss(capsys, tmp_path):
    base = ["--reduced", "--device", "cpu", "--hybrid-mesh", "2,1,2,2",
            "--microbatches", "4", "--steps", "6", "--batch", "16", "--seq",
            "32"]

    def final(out):
        line = [ln for ln in out.splitlines() if ln.startswith("done:")][0]
        return line.split()[3]

    launch_train.main(base + ["--ckpt-dir", str(tmp_path / "ckpt"),
                              "--ckpt-every", "2", "--fault-plan",
                              "shrink=3:data", "--elastic"])
    chaos = capsys.readouterr().out
    assert "mesh_shrinks=1" in chaos and "virtual_dp=2" in chaos
    assert "4 left" in chaos
    launch_train.main(base)
    clean = capsys.readouterr().out
    assert final(chaos) == final(clean), chaos + clean
