"""The port's spans (``repro_torch.tracing.span``) under ``torch.profiler``
on the host: nothing made while the profiler is off, and each span where
its work happens, as many times as that work runs: the optimizer update,
each kernel's recomputed backward, the serving engine's prefill and
decode steps, and each sublayer's mixer and FFN, nested under them.
"""

from __future__ import annotations

import collections

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import init_params
from repro_torch.models.model import shard_train_params
from repro_torch.optim import Adafactor, AdamW
from repro_torch.serve import ServeEngine
from repro_torch.sharding import Policy
from repro_torch.train.step import build_train_step, init_train_state

PREFIXES = ("optim.", "kernels.", "serve.", "model.")


def _spans(prof) -> list:
    return [e for e in prof.events() if e.name.startswith(PREFIXES)]


def _counts(prof) -> dict:
    return dict(collections.Counter(e.name for e in _spans(prof)))


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_one_shared_object_and_makes_no_record(monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    a, b = tracing.span("model.attn"), tracing.span("serve.decode_step")
    assert a is b
    with a:
        pass
    assert made == []
    with _recording() as prof:
        with tracing.span("model.ffn"):
            pass
    assert made == ["model.ffn"]
    assert _counts(prof) == {"model.ffn": 1}


class _Port:
    value = 0


@pytest.fixture(scope="module")
def policy():
    """A (1, 1) mesh in this process, as the benchmark's train cell runs
    the policy train program on one card."""
    alone = not dist.is_initialized()
    if alone:
        launch_mesh.init_world(0, 1, device="cpu", port=_Port())
    yield Policy(launch_mesh.make_host_mesh((1, 1), device="cpu",
                                            all_ranks_group=True))
    if alone:
        dist.destroy_process_group()


def _glm():
    cfg = reduced(get_config("glm4-9b"))
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def test_policy_train_step_spans(policy):
    cfg, params = _glm()
    assert cfg.remat and cfg.num_layers == 2
    opt = AdamW(lr=lambda count: 1e-3)
    step = build_train_step(cfg, opt, policy=policy)
    state = init_train_state(cfg, shard_train_params(cfg, params, policy),
                             opt)
    tok = torch.randint(0, cfg.vocab_size, (2, 17),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with _recording() as prof:
        state, _ = step(state, batch)
    # the remat reruns each sublayer's forward in the backward
    assert _counts(prof) == {"optim.update": 1, "model.attn": 4,
                             "model.ffn": 4,
                             "kernels.flash_attention.bwd": 2,
                             "kernels.rmsnorm.bwd": 5}


def test_generate_spans_nest_the_sublayers():
    cfg, params = _glm()
    engine = ServeEngine(cfg, params, max_seq=16, batch_size=2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(2))
    with _recording() as prof:
        engine.generate(prompt, steps=3)
    assert _counts(prof) == {"serve.prefill": 1, "serve.decode_step": 3,
                             "model.attn": 8, "model.ffn": 8}
    for e in _spans(prof):
        if e.name.startswith("model."):
            assert e.cpu_parent.name in ("serve.prefill", "serve.decode_step")


def test_ssm_sublayer_span():
    cfg = reduced(get_config("mamba2-370m"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = ServeEngine(cfg, params, max_seq=12, batch_size=1)
    with _recording() as prof:
        engine.prefill(torch.zeros((1, 8), dtype=torch.long))
    assert _counts(prof) == {"serve.prefill": 1,
                             "model.ssm": cfg.num_layers}


@pytest.mark.parametrize("make", [lambda: AdamW(lr=lambda c: 1e-3),
                                  lambda: Adafactor(lr=lambda c: 1e-3)],
                         ids=["adamw", "adafactor"])
def test_optimizer_update_is_one_span(make):
    opt = make()
    params = {"w": torch.ones(4, 3), "b": torch.ones(3)}
    state = opt.init(params)
    grads = {k: torch.full_like(p, 0.5) for k, p in params.items()}
    with _recording() as prof:
        opt.update(grads, state, params)
    assert _counts(prof) == {"optim.update": 1}


def _flash(req):
    q = torch.randn(1, 8, 2, 16, requires_grad=req[0])
    kv = [torch.randn(1, 8, 1, 16, requires_grad=r) for r in req[1:]]
    return ops.flash_attention(q, *kv).sum()


def _rmsnorm(req):
    return ops.rmsnorm(torch.randn(4, 16, requires_grad=req[0]),
                       torch.ones(16, requires_grad=req[1])).sum()


def _ssd(req):
    x = torch.randn(1, 8, 2, 4, requires_grad=req[0])
    dt = torch.rand(1, 8, 2) * 0.1
    y, _ = ops.ssd_scan(x, dt, -torch.ones(2), torch.randn(1, 8, 4),
                        torch.randn(1, 8, 4), chunk=4)
    return y.sum()


@pytest.mark.parametrize("name,loss", [("flash_attention", _flash),
                                       ("rmsnorm", _rmsnorm),
                                       ("ssd_scan", _ssd)])
def test_kernel_backward_is_one_span(name, loss):
    out = loss((True, True, True))
    with _recording() as prof:
        out.backward()
    assert _counts(prof) == {f"kernels.{name}.bwd": 1}
