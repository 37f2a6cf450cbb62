"""The port's fault injection, checkpointed supervisor and loop
(``repro_torch/resilience/inject.py``, ``train/loop.py``) against the JAX
package's.

- Every case of ``tests/test_resilience.py`` and ``tests/test_train_loop.py``
  that reads no JAX internals, port against port on reduced phi4-mini:
  the guard inside the step (bitwise skip, inert on clean steps), the
  injector's fire-once, the chaos run (poison at 5, crash at 9 damaging
  the newest checkpoint) healing to the fault-free run exactly, the
  NaN-streak rollback logging ``data_offset=3``, loss falling, a crash
  resumed deterministically, keep-k, the health counters, the straggler
  monitor.
- ``FaultPlan.parse`` equal to the reference's, field by field, and
  ``corrupt_checkpoint`` damaging the same byte of the same file at the
  same seed.
- Both packages' supervisors over the same scripted steps and checkpoint
  directories (chaos, NaN streak, a plain crash, a truncated counter):
  histories, every health counter but the clock's ``slow_steps``, the
  seeded backoff and the directories left agree.
- The CLI's ported flags (``--ckpt-dir``, ``--ckpt-every``,
  ``--fault-plan``, ``--elastic``) and ``examples/train_lm_torch.py`` on
  the host.
"""

import dataclasses
import importlib.util
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import resilience as jres
from repro import train as jtrain
from repro.checkpoint import ckpt as jckpt
from repro_torch import configs, data, train
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.optim import make_optimizer
from repro_torch.resilience import (FaultInjector, FaultPlan, InjectedCrash,
                                    corrupt_checkpoint, nan_grad_hook,
                                    poison_batch)
from repro_torch.train import (LoopConfig, NonFiniteStreakError,
                               StragglerMonitor, build_train_step,
                               init_train_state, restart_on_failure, run)

ROOT = Path(__file__).resolve().parent.parent
TOTAL = 12
QUIET = dict(logger=lambda *a: None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread, so the many parallel
    regions of a step do not wait for threads that other test workers'
    processes keep off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _It:
    def __init__(self, data, start):
        self.data, self.s = data, start

    def __next__(self):
        s = self.s
        self.s += 1
        return s, self.data.batch(s)


@pytest.fixture(scope="module")
def rig():
    cfg = configs.reduced(configs.get_config("phi4-mini-3.8b"))
    ds = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=32, global_batch=8,
                                          seed=3))
    opt = make_optimizer("adamw", total_steps=TOTAL, base_lr=1e-3)

    def make_state():
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        return init_train_state(cfg, params, opt)

    return dict(cfg=cfg, opt=opt, data=ds, make_state=make_state,
                make_iter=lambda s: _It(ds, s),
                step=build_train_step(cfg, opt),
                poisoned=build_train_step(cfg, opt,
                                          fault_hook=nan_grad_hook()),
                inf_poisoned=build_train_step(
                    cfg, opt, fault_hook=nan_grad_hook(float("inf"))))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# tests/test_resilience.py, port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["poisoned", "inf_poisoned"])
def test_guard_skips_bitwise_and_recovers(rig, variant):
    state = rig["make_state"]()
    s1, m1 = rig["step"](state, rig["data"].batch(0))
    assert int(m1["skipped"]) == 0
    before = _clone(s1)
    s2, m2 = rig[variant](s1, rig["data"].batch(1))
    assert int(m2["skipped"]) == 1
    _assert_equal(s2["params"], before["params"])
    _assert_equal(s2["opt"], before["opt"])
    assert s2["step"] == before["step"] + 1 and s2["skipped_steps"] == 1
    mid = _clone(s2["params"])
    s3, m3 = rig["step"](s2, rig["data"].batch(2))
    assert int(m3["skipped"]) == 0 and s3["skipped_steps"] == 1
    assert any(not torch.equal(mid[k], s3["params"][k]) for k in mid)


def test_guard_is_inert_on_clean_steps(rig):
    unguarded = build_train_step(rig["cfg"], rig["opt"],
                                 nonfinite_guard=False)
    sg, su = rig["make_state"](), rig["make_state"]()
    for i in range(2):
        b = rig["data"].batch(i)
        sg, mg = rig["step"](sg, b)
        su, mu = unguarded(su, b)
        assert float(mg["loss"]) == float(mu["loss"])
    _assert_equal(sg["params"], su["params"])


PLANS = ["poison=3+4,crash=9,corrupt=truncate,slow=4:0.2,seed=1,persistent",
         "shrink=6:data", "shrink=6:data+9:ctx", "poison=5,crash=9,"
         "corrupt=bitflip", "value=inf,poison=2,array=params/w,slow=3",
         "poison=3,crash=5,corrupt=bitflip"]


@pytest.mark.parametrize("spec", PLANS)
def test_fault_plan_parse_matches_reference(spec):
    got = dataclasses.asdict(FaultPlan.parse(spec))
    want = dataclasses.asdict(jres.FaultPlan.parse(spec))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == v or (v != v and got[k] != got[k]), k


@pytest.mark.parametrize("spec,match", [("corrupt=scribble", "bitflip"),
                                        ("frobnicate=1", "unknown"),
                                        ("shrink=6", "step:axis"),
                                        ("oops", "bad fault-plan")])
def test_fault_plan_parse_errors_match_reference(spec, match):
    for parse in (FaultPlan.parse, jres.FaultPlan.parse):
        with pytest.raises(ValueError, match=match):
            parse(spec)


def test_injector_fire_once_semantics(rig):
    inj = FaultInjector(FaultPlan.parse("crash=1"), rig["step"])
    s1, _ = inj(rig["make_state"](), rig["data"].batch(0))
    with pytest.raises(InjectedCrash):
        inj(s1, rig["data"].batch(1))
    s2, _ = inj(s1, rig["data"].batch(1))      # replay: spent, runs clean
    assert s2["step"] == 2


def test_chaos_self_heals_to_exact_golden(rig, tmp_path):
    """poison@5 (guard skips) -> crash@9 damaging the newest checkpoint
    (step 8, which holds the skip) -> quarantine, fall back to step 4,
    replay with the injection spent -> params and moments EXACTLY equal
    to the fault-free run."""
    d = str(tmp_path / "ckpt")
    inj = FaultInjector(FaultPlan.parse("poison=5,crash=9,corrupt=bitflip"),
                        rig["step"], poisoned_step_fn=rig["poisoned"],
                        ckpt_dir=d)
    loop_cfg = LoopConfig(total_steps=TOTAL, ckpt_dir=d, ckpt_every=4,
                          keep=5, log_every=1000)
    state, hist = restart_on_failure(rig["make_state"], inj,
                                     rig["make_iter"], loop_cfg,
                                     backoff_base=0.01, **QUIET)
    golden, ghist = run(rig["make_state"](), rig["step"], rig["make_iter"](0),
                        LoopConfig(total_steps=TOTAL, log_every=1000),
                        **QUIET)
    _assert_equal(state["params"], golden["params"])
    _assert_equal(state["opt"], golden["opt"])
    assert hist[-1]["loss"] == ghist[-1]["loss"]
    assert state["step"] == TOTAL
    assert (hist.health["restarts"], hist.health["quarantined_checkpoints"],
            hist.health["skipped_steps"]) == (1, 1, 1)
    assert hist.health["backoff_seconds"] > 0


def test_restarts_restore_without_a_second_state(rig, tmp_path):
    """Two crashes, two restores: the state is built once, at the cold
    start; each restore lands on its memoryless skeleton (meta tensors)
    on the state's device, and the run ends bitwise on the fault-free
    run."""
    d = str(tmp_path / "ckpt")
    built = []

    def make_state():
        built.append(1)
        return rig["make_state"]()

    inj = FaultInjector(FaultPlan.parse("crash=5+9"), rig["step"], ckpt_dir=d)
    loop_cfg = LoopConfig(total_steps=TOTAL, ckpt_dir=d, ckpt_every=4,
                          keep=5, log_every=1000)
    state, hist = restart_on_failure(make_state, inj, rig["make_iter"],
                                     loop_cfg, backoff_base=0.01, **QUIET)
    golden, _ = run(rig["make_state"](), rig["step"], rig["make_iter"](0),
                    LoopConfig(total_steps=TOTAL, log_every=1000), **QUIET)
    assert (len(built), hist.health["restarts"]) == (1, 2)
    assert all(t.device.type == "cpu" for t in state["params"].values())
    _assert_equal(state["params"], golden["params"])
    _assert_equal(state["opt"], golden["opt"])
    assert state["step"] == TOTAL


def test_nan_streak_rolls_back_and_advances_data(rig, tmp_path):
    d = str(tmp_path / "ckpt")
    inj = FaultInjector(FaultPlan.parse("poison=5+6"), rig["step"],
                        poisoned_step_fn=rig["poisoned"], ckpt_dir=d)
    loop_cfg = LoopConfig(total_steps=TOTAL, ckpt_dir=d, ckpt_every=4,
                          keep=5, log_every=1000, async_ckpt=False,
                          rollback_after_skips=2)
    logs = []
    state, hist = restart_on_failure(rig["make_state"], inj,
                                     rig["make_iter"], loop_cfg,
                                     backoff_base=0.01, logger=logs.append)
    assert hist.health["rollbacks"] == 1
    assert hist.health["skipped_steps"] == 2
    assert state["step"] == TOTAL
    assert any("data_offset=3" in line for line in logs)


def test_streak_error_carries_window():
    e = NonFiniteStreakError(5, 7, 3)
    assert (e.first_step, e.last_step, e.streak) == (5, 7, 3)


def test_unrecoverable_exception_propagates(rig, tmp_path):
    def bad_step(state, batch):
        raise TypeError("programming error, not a fault")
    loop_cfg = LoopConfig(total_steps=TOTAL, ckpt_dir=str(tmp_path / "c"),
                          log_every=1000)
    with pytest.raises(TypeError):
        restart_on_failure(rig["make_state"], bad_step, rig["make_iter"],
                           loop_cfg, backoff_base=0.01, **QUIET)


def test_corrupt_checkpoint_targets_named_array(tmp_path):
    d = str(tmp_path)
    s = {"params": {"w": torch.arange(512.0)}, "step": 1}
    ckpt_lib.save(d, 1, s)
    fpath = corrupt_checkpoint(d, array="params/w", mode="bitflip", seed=7)
    assert fpath.endswith(".npy")
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        ckpt_lib.restore(d, like=s)


@pytest.mark.parametrize("mode,seed,array", [
    ("bitflip", 0, None), ("bitflip", 7, "params/b"), ("bitflip", 123, None),
    ("truncate", 0, "step")])
def test_corrupt_checkpoint_damages_the_reference_byte(tmp_path, mode, seed,
                                                       array):
    """The same checkpoint saved by each package, damaged by each package's
    corrupt_checkpoint at the same seed: the same file, the same bytes."""
    import jax.numpy as jnp
    a = np.arange(3000, dtype=np.float32) / 7
    b = np.arange(40, dtype=np.float32)
    jckpt.save(str(tmp_path / "jax"), 3, {"params": {
        "a": jnp.asarray(a), "b": jnp.asarray(b)}, "step": jnp.int32(3)})
    ckpt_lib.save(str(tmp_path / "port"), 3, {"params": {
        "a": torch.from_numpy(a), "b": torch.from_numpy(b)}, "step": 3})
    got = corrupt_checkpoint(str(tmp_path / "port"), array=array, mode=mode,
                             seed=seed)
    want = jres.corrupt_checkpoint(str(tmp_path / "jax"), array=array,
                                   mode=mode, seed=seed)
    assert os.path.basename(got) == os.path.basename(want)
    assert Path(got).read_bytes() == Path(want).read_bytes()


def test_poison_batch_sets_float_leaves_only():
    out, n = poison_batch({"x": np.ones(3, np.float32),
                           "tokens": np.arange(3)})
    assert n == 1 and np.isnan(out["x"][0]) and out["tokens"][0] == 0


# ---------------------------------------------------------------------------
# Both packages' supervisors over the same scripted steps
# ---------------------------------------------------------------------------

class _Steps:
    """A stand-in train step over integer states: loss = batch index,
    skipped when built ``poisoned``."""

    def __init__(self, poisoned=False):
        self.poisoned = poisoned

    def __call__(self, state, batch):
        return ({"step": state["step"] + 1},
                {"loss": float(batch["index"]), "grad_norm": 1.0,
                 "skipped": int(self.poisoned)})


class _Indices:
    def __init__(self, start):
        self.step = start

    def __next__(self):
        self.step += 1
        return self.step - 1, {"index": np.int32(self.step - 1)}


SCENARIOS = {   # plan, LoopConfig extras
    "chaos": ("poison=5,crash=9,corrupt=bitflip", {}),
    "nan_streak": ("poison=5+6", {"rollback_after_skips": 2,
                                  "async_ckpt": False}),
    "crash": ("crash=7", {"async_ckpt": False}),
    "truncate": ("crash=10,corrupt=truncate,array=step", {"keep": 2}),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_supervisors_match_jax(tmp_path, case):
    import jax.numpy as jnp
    spec, extra = SCENARIOS[case]
    runs = {}
    for name, mod, plan_cls, injector_cls, zero in (
            ("port", train, FaultPlan, FaultInjector, 0),
            ("jax", jtrain, jres.FaultPlan, jres.FaultInjector,
             jnp.int32(0))):
        d = str(tmp_path / name)
        inj = injector_cls(plan_cls.parse(spec), _Steps(),
                           poisoned_step_fn=_Steps(True), ckpt_dir=d)
        sleeps = []
        loop_cfg = mod.LoopConfig(total_steps=TOTAL, ckpt_dir=d,
                                  ckpt_every=4, log_every=1000,
                                  **{"keep": 5, **extra})
        _, hist = mod.restart_on_failure(
            lambda z=zero: {"step": z}, inj, _Indices, loop_cfg, seed=5,
            logger=lambda s: None, sleep=sleeps.append)
        runs[name] = (hist, sleeps, sorted(os.listdir(d)))
    (hist, sleeps, files), (jhist, jsleeps, jfiles) = runs["port"], runs["jax"]
    assert sleeps == jsleeps and len(sleeps) >= 1
    assert [(r["step"], r["loss"], r["skipped"]) for r in hist] == [
        (r["step"], r["loss"], r["skipped"]) for r in jhist]
    timed = {"slow_steps"}          # the straggler monitor reads the clock
    assert hist.health.keys() == jhist.health.keys()
    assert {k: v for k, v in hist.health.items() if k not in timed} == {
        k: v for k, v in jhist.health.items() if k not in timed}
    assert files == jfiles


# ---------------------------------------------------------------------------
# tests/test_train_loop.py, port against port
# ---------------------------------------------------------------------------

def test_loss_decreases(rig):
    opt = make_optimizer("adamw", total_steps=30, base_lr=1e-3)
    params = init_params(rig["cfg"], torch.Generator().manual_seed(0), "cpu")
    _, hist = run(init_train_state(rig["cfg"], params, opt),
                  build_train_step(rig["cfg"], opt), rig["make_iter"](0),
                  LoopConfig(total_steps=30, log_every=1000), **QUIET)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.2, (first, last)


def test_fault_injection_and_resume_is_deterministic(rig, tmp_path):
    cfg_a = LoopConfig(total_steps=TOTAL, ckpt_dir=str(tmp_path / "a"),
                       ckpt_every=4, async_ckpt=False, log_every=1000)
    state_a, _ = run(rig["make_state"](), rig["step"], rig["make_iter"](0),
                     cfg_a, **QUIET)
    cfg_b = dataclasses.replace(cfg_a, ckpt_dir=str(tmp_path / "b"),
                                fail_at_step=9)
    state_b, hist_b = restart_on_failure(rig["make_state"], rig["step"],
                                         rig["make_iter"], cfg_b,
                                         backoff_base=0.01, **QUIET)
    _assert_equal(state_a["params"], state_b["params"])
    assert state_b["step"] == TOTAL
    assert hist_b.health["restarts"] == 1
    assert [h["step"] for h in hist_b] == list(range(9)) + list(range(8, 12))


def test_checkpoint_atomicity_keep_k(rig, tmp_path):
    cfg = LoopConfig(total_steps=TOTAL, ckpt_dir=str(tmp_path), ckpt_every=2,
                     keep=2, async_ckpt=False, log_every=1000)
    run(rig["make_state"](), rig["step"], rig["make_iter"](0), cfg, **QUIET)
    assert sorted(os.listdir(tmp_path)) == ["step_00000010", "step_00000012"]


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.5, factor=1.5)
    assert not m.observe(1.0)
    assert not m.observe(1.1)
    assert m.observe(5.0)
    assert m.slow_steps == 1


# ---------------------------------------------------------------------------
# The CLI's ported flags and the example
# ---------------------------------------------------------------------------

def _cli(capsys, *argv):
    launch_train.main(["--reduced", "--device", "cpu", "--batch", "4",
                       "--seq", "16", *argv])
    out = capsys.readouterr().out
    done = [line for line in out.splitlines() if line.startswith("done:")]
    assert len(done) == 1, out
    return out, done[0].split()[3]


def test_cli_ckpt_dir_resumes(capsys, tmp_path):
    """Run again after stopping before its last save, the same command
    resumes from the newest checkpoint and ends where the whole run ended
    (the data is addressed by step, the schedule by --steps)."""
    d = str(tmp_path / "ckpt")
    argv = ("--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2")
    _, whole = _cli(capsys, *argv)
    shutil.rmtree(os.path.join(d, "step_00000006"))
    out, resumed = _cli(capsys, *argv)
    assert "resumed from checkpoint step 4" in out and "over 2 steps" in out
    assert resumed == whole


def test_cli_fault_plan_heals(capsys, tmp_path):
    out, chaos = _cli(capsys, "--steps", "6", "--ckpt-dir",
                      str(tmp_path / "c"), "--ckpt-every", "2",
                      "--fault-plan", "poison=3,crash=5,corrupt=bitflip")
    assert "restarts=1" in out and "quarantined_checkpoints=1" in out
    assert "skipped_steps=1" in out
    _, clean = _cli(capsys, "--steps", "6")
    assert chaos == clean


def test_cli_elastic_requires_hybrid_mesh():
    with pytest.raises(SystemExit, match="--elastic requires --hybrid-mesh"):
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1",
                           "--elastic"])


@pytest.mark.parametrize("argv", [
    ["--hybrid-mesh", "1,1,1", "--elastic"],
    ["--hybrid-mesh", "1,1,2,1", "--ckpt-dir", "{d}", "--ckpt-every", "1"],
    ["--hybrid-mesh", "1,1,1", "--fault-plan", "poison=1,crash=2",
     "--ckpt-dir", "{d}", "--ckpt-every", "1"],
])
def test_cli_hybrid_flags_run(capsys, tmp_path, argv):
    argv = [a.format(d=tmp_path / "ckpt") for a in argv]
    out, loss = _cli(capsys, "--steps", "3", "--batch", "4", "--seq", "16",
                     "--microbatches", "2", *argv)
    assert np.isfinite(float(loss))
    if "--fault-plan" in argv:
        assert "restarts=1" in out and "skipped_steps=1" in out
        assert "resumed from checkpoint step 2" in out
    if "--ckpt-dir" in argv:
        assert ckpt_lib.latest_step(str(tmp_path / "ckpt")) == 3


def test_train_lm_example_resumes_on_the_host(capsys, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    argv = ["--device", "cpu", "--tiny", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    example.main(argv + ["--steps", "4"])
    assert "loss: first" in capsys.readouterr().out
    example.main(argv + ["--steps", "6"])
    assert "resumed from checkpoint step 4" in capsys.readouterr().out
