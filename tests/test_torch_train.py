"""The port's single-device training path against the JAX package's, live.

JAX initialises the parameters; ``params_from_jax`` carries them over leaf
by leaf.  Both sides read the same ``SyntheticLM`` batches.  The loss, every
grad leaf, and the params, moments and counters after two AdamW steps must
agree at 1e-4, the reference's golden tolerance
(``tests/md/test_golden.py:11``), computed live, never against the
``GOLDEN`` constants.  reduced(glm4-9b) is GQA attention, reduced(phi4-mini)
adds tied embeddings, reduced(mamba2-370m) is the SSM (conv, dt and A
paths and the SSD scan's backward).  The JAX model's train attention is
``blockwise_attention`` unless ``use_flash``; the port's always goes through
``ops.flash_attention``, and must match both routes.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import train as jtrain
from repro.models import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs, data, train
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.optim import make_optimizer

TOL = 1e-4
ARCHS = ["glm4-9b", "phi4-mini-3.8b", "mamba2-370m", "kimi-k2-1t-a32b",
         "llama4-maverick-400b-a17b"]
B, S = 4, 24
SRC = Path(__file__).resolve().parent.parent / "src"


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _dataset(cfg, mod=data, seed=0):
    return mod.SyntheticLM(mod.DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=S, global_batch=B,
                                          seed=seed))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """(cfg, JAX cfg, JAX params) by arch, made on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jconfigs.reduced(jconfigs.get_config(arch))
            cache[arch] = (configs.reduced(configs.get_config(arch)), jcfg,
                           jinit_params(jcfg, jax.random.PRNGKey(0)))
        return cache[arch]
    return get


@pytest.mark.parametrize("seed,step,host_index,host_count", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2), (11, 5, 3, 4)])
def test_synthetic_lm_batches_are_byte_identical(seed, step, host_index,
                                                 host_count):
    kw = dict(vocab_size=512, seq_len=33, global_batch=8, seed=seed,
              host_index=host_index, host_count=host_count)
    got = data.SyntheticLM(data.DataConfig(**kw)).batch(step)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()


def test_prefetch_iterator_yields_steps_in_order():
    ds = _dataset(configs.reduced(configs.get_config("glm4-9b")))
    it = data.PrefetchIterator(ds, start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = next(it)
            assert step == want
            assert batch["tokens"].tobytes() == ds.batch(want)[
                "tokens"].tobytes()
    finally:
        it.close()


@pytest.mark.parametrize("arch,use_flash", [
    ("glm4-9b", False), ("glm4-9b", True), ("phi4-mini-3.8b", False),
    ("phi4-mini-3.8b", True), ("mamba2-370m", False),  # mamba2: no attention
    ("kimi-k2-1t-a32b", False), ("kimi-k2-1t-a32b", True),
    ("llama4-maverick-400b-a17b", False)])
def test_loss_and_every_grad_leaf_match_jax(models, arch, use_flash):
    cfg, jcfg, jparams = models(arch)
    batch = _dataset(cfg).batch(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jtrain.build_loss_fn(jcfg, None, use_flash=use_flash),
        has_aux=True))(jparams, _jbatch(batch))
    params = params_from_jax(jax.device_get(jparams))
    loss, met, grads = train.loss_and_grads(
        train.build_loss_fn(cfg), params, train.batch_to_device(batch, "cpu"))
    _close(loss, jloss, "loss")
    _close(met["nll"], jmet["nll"], "nll")
    _close(met["aux"], jmet["aux"], "aux")
    jgrads = flatten(jax.device_get(jgrads))
    assert set(grads) == set(jgrads)
    for name, leaf in jgrads.items():
        assert grads[name].dtype == params[name].dtype, name
        _close(grads[name], leaf, name)
    assert not any(p.requires_grad for p in params.values())


def test_jamba_loss_matches_jax(models):
    """reduced jamba's loss, nll and MoE aux at the pin.  Its grads are
    held sublayer by sublayer (``tests/test_torch_model.py::
    test_jamba_sublayer_vjps_match_jax``): end to end its fp32 forward
    amplifies rounding past the pin, its grads likewise."""
    cfg, jcfg, jparams = models("jamba-v0.1-52b")
    batch = _dataset(cfg).batch(0)
    jloss, jmet = jax.jit(jtrain.build_loss_fn(jcfg, None))(
        jparams, _jbatch(batch))
    loss, met, _ = train.loss_and_grads(
        train.build_loss_fn(cfg), params_from_jax(jax.device_get(jparams)),
        train.batch_to_device(batch, "cpu"))
    for key in ("nll", "aux"):
        _close(met[key], jmet[key], key)
    _close(loss, jloss, "loss")
    assert float(met["aux"]) > 0


@pytest.fixture(scope="module")
def jax_steps():
    """Jitted JAX train steps, one per (arch, grad_accum), shared."""
    return {}


def _jax_step(jax_steps, jcfg, accum, **kw):
    key = (jcfg.name, accum, tuple(sorted(kw.items())))
    if key not in jax_steps:
        jcfg = dataclasses.replace(jcfg, grad_accum=accum)
        opt = jmake_optimizer(jcfg.optimizer, total_steps=10, base_lr=1e-3)
        jax_steps[key] = (jax.jit(jtrain.build_train_step(jcfg, None, opt,
                                                          **kw)), opt)
    return jax_steps[key]


def _port_step(cfg, accum, **kw):
    cfg = dataclasses.replace(cfg, grad_accum=accum)
    opt = make_optimizer(cfg.optimizer, total_steps=10, base_lr=1e-3)
    return train.build_train_step(cfg, opt, **kw), opt


@pytest.mark.parametrize("arch,accum,grad_compress", [
    (arch, accum, False) for arch in ARCHS for accum in (1, 2)] + [
    ("glm4-9b", 1, True)])
def test_two_train_steps_match_jax(models, jax_steps, arch, accum,
                                   grad_compress):
    """Two steps of the arch's optimizer (clip folded in, guard on): loss
    and grad norm of each, then params, both moments, ``count``, ``step``
    and ``skipped_steps``; once with the bf16 gradient compression.  A
    moment stored in bf16 (llama4's ``adamw_bf16``, kimi's Adafactor) may
    differ by one bf16 rounding (2^-8 relative) where the fp32 values sit
    on a rounding boundary, as in ``tests/test_torch_optim.py``."""
    cfg, jcfg, jparams = models(arch)
    jstep, jopt = _jax_step(jax_steps, jcfg, accum,
                            grad_compress=grad_compress)
    step, opt = _port_step(cfg, accum, grad_compress=grad_compress)
    jstate = jtrain.init_train_state(jcfg, jparams, jopt)
    state = train.init_train_state(
        cfg, params_from_jax(jax.device_get(jparams)), opt)
    ds = _dataset(cfg, seed=1)
    for i in range(2):
        jstate, jmet = jstep(jstate, _jbatch(ds.batch(i)))
        state, met = step(state, ds.batch(i))
        for key in ("loss", "grad_norm", "nll"):
            _close(met[key], jmet[key], f"step {i} {key}")
        assert met["skipped"] == int(jmet["skipped"]) == 0
    assert state["step"] == int(jstate["step"]) == 2
    assert state["skipped_steps"] == int(jstate["skipped_steps"]) == 0
    assert state["opt"]["count"] == int(jstate["opt"]["count"]) == 2
    for part, got in (("params", state["params"]),
                      ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
        tree = jstate["params"] if part == "params" else jstate["opt"][part]
        want = flatten(jax.device_get(tree))
        got = flatten(got)   # Adafactor's factored statistics nest
        assert set(got) == set(want)
        for name, leaf in want.items():
            bf16 = part != "params" and got[name].dtype == torch.bfloat16
            _close(got[name], leaf, f"{part} {name}",
                   2 ** -8 if bf16 else TOL)


def _poison_first_leaf(grads):
    """NaN at element 0 of the first leaf, as ``nan_grad_hook`` does."""
    first = sorted(grads)[0]
    g = grads[first].clone()
    g.view(-1)[0] = float("nan")
    return dict(grads, **{first: g})


def test_guard_skips_a_poisoned_step_bitwise(models):
    cfg, _, jparams = models("glm4-9b")
    poisoned, opt = _port_step(cfg, 1, fault_hook=_poison_first_leaf)
    clean, _ = _port_step(cfg, 1)
    state = train.init_train_state(
        cfg, params_from_jax(jax.device_get(jparams)), opt)
    ds = _dataset(cfg)
    state, _ = clean(state, ds.batch(0))
    before = {part: {k: v.clone() for k, v in tree.items()} for part, tree in
              (("params", state["params"]), ("m", state["opt"]["m"]),
               ("v", state["opt"]["v"]))}
    state, met = poisoned(state, ds.batch(1))
    assert met["skipped"] == 1 and not np.isfinite(float(met["grad_norm"]))
    assert state["step"] == 2 and state["skipped_steps"] == 1
    assert state["opt"]["count"] == 1
    for part, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        for k, v in tree.items():
            assert torch.equal(v, before[part][k]), f"{part} {k}"
    state, met = clean(state, ds.batch(2))
    assert met["skipped"] == 0 and state["skipped_steps"] == 1
    assert state["opt"]["count"] == 2


def test_run_history_matches_jax(models, jax_steps):
    """Five steps of reduced glm4-9b through each package's ``run``."""
    cfg, jcfg, jparams = models("glm4-9b")
    jstep, jopt = _jax_step(jax_steps, jcfg, 1)
    step, opt = _port_step(cfg, 1)
    loop_cfg = dict(total_steps=5, log_every=1)
    jit = jdata.PrefetchIterator(_dataset(jcfg, jdata))
    it = data.PrefetchIterator(_dataset(cfg))
    try:
        _, jhist = jtrain.run(jtrain.init_train_state(jcfg, jparams, jopt),
                              jstep, jit, jtrain.LoopConfig(**loop_cfg),
                              logger=lambda s: None)
        state, hist = train.run(
            train.init_train_state(cfg, params_from_jax(
                jax.device_get(jparams)), opt),
            step, it, train.LoopConfig(**loop_cfg), logger=lambda s: None)
    finally:
        jit.close()
        it.close()
    assert len(hist) == len(jhist) == 5 and state["step"] == 5
    for rec, jrec in zip(hist, jhist):
        assert rec["step"] == jrec["step"]
        for key in ("loss", "grad_norm", "nll"):
            _close(rec[key], jrec[key], f"step {rec['step']} {key}")
        assert rec["skipped"] == jrec["skipped"] == 0
    for key in ("restarts", "rollbacks", "skipped_steps"):
        assert hist.health[key] == jhist.health[key] == 0


class _Script:
    """A stand-in train step over integer states: the guard skips the steps
    whose batch index lies in ``poisoned``."""

    def __init__(self, poisoned=()):
        self.poisoned = set(poisoned)

    def __call__(self, state, batch):
        bad = int(batch["index"]) in self.poisoned
        return ({"step": state["step"] + 1},
                {"loss": float(batch["index"]), "grad_norm": 1.0,
                 "skipped": int(bad)})


class _Indices:
    def __init__(self, start):
        self.step = start

    def __next__(self):
        self.step += 1
        return self.step - 1, {"index": np.int32(self.step - 1)}


@pytest.mark.parametrize("case", ["fail_at_step", "nan_streak"])
def test_restart_on_failure_matches_jax(case):
    """The supervisor of each package over the same scripted steps:
    ``fail_at_step`` restarts once from ``make_state()``; a NaN streak of
    ``rollback_after_skips`` steps rolls back and shifts the data past the
    window.  Histories, health counters and the seeded jittered backoff
    agree."""
    kw = dict(total_steps=6, log_every=100)
    if case == "fail_at_step":
        kw["fail_at_step"], poisoned = 2, ()
    else:
        kw["rollback_after_skips"], poisoned = 2, (3, 4)
    runs = {}
    for mod in (train, jtrain):
        sleeps = []
        _, hist = mod.restart_on_failure(
            lambda: {"step": 0}, _Script(poisoned), _Indices,
            mod.LoopConfig(**kw), seed=5, logger=lambda s: None,
            sleep=sleeps.append)
        runs[mod] = (hist, sleeps)
    (hist, sleeps), (jhist, jsleeps) = runs[train], runs[jtrain]
    assert sleeps == jsleeps and len(sleeps) == 1
    assert [(r["step"], r["loss"], r["skipped"]) for r in hist] == [
        (r["step"], r["loss"], r["skipped"]) for r in jhist]
    for key in ("restarts", "rollbacks", "skipped_steps", "backoff_seconds"):
        assert hist.health[key] == jhist.health[key], key
    if case == "nan_streak":
        assert hist.health["rollbacks"] == 1
        assert hist[-1]["loss"] == 5 + 5       # data_offset 5 past the window
    else:
        assert hist.health["restarts"] == 1


def test_train_cli_on_the_host():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "3", "--use-flash"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "glm4-9b: 0.1M params, device=cpu" in proc.stdout
    assert "done: final loss" in proc.stdout
    assert "skipped_steps=0" in proc.stdout
