"""The plain reference against the port on the host, at reduced sizes in
float32: the logits of the forward, the loss and every gradient, for a
dense GQA model and a Mamba-2 model; and the reference's chunked SSD
against the one-step-at-a-time recurrence."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

import harness  # noqa: E402
from reference import model  # noqa: E402
from reference.inputs import make_weights, train_batch  # noqa: E402

DENSE = {"program": "glm4-9b", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
         "vocab_size": 211, "mlp_type": "swiglu", "rope_theta": 10000.0,
         "tie_embeddings": False, "dtype": "float32"}
SSM = {"program": "mamba2-370m", "num_layers": 2, "d_model": 64,
       "num_heads": 0, "num_kv_heads": 0, "head_dim": 0, "d_ff": 0,
       "vocab_size": 211, "ssm_state": 16, "ssm_expand": 2,
       "ssm_head_dim": 16, "conv_kernel": 4, "tie_embeddings": True,
       "dtype": "float32"}
CONFS = {"dense": DENSE, "ssm": SSM}


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads, as the other test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _weights(conf, seed=3):
    w = make_weights(conf, seed, "cpu")
    if "blocks.pos0.ssm.dt_bias" in w:    # leaves the draw holds constant
        g = torch.Generator().manual_seed(seed)
        for k in ("dt_bias", "d_skip", "ssm_norm"):
            key = "blocks.pos0.ssm." + k
            w[key] = w[key] + 0.3 * torch.randn(w[key].shape, generator=g)
    return w


@pytest.mark.parametrize("kind", CONFS)
def test_logits_match_the_port(kind):
    from repro_torch.models import forward
    conf = CONFS[kind]
    w = _weights(conf)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, conf["vocab_size"], (2, 300)))
    want, _, _ = forward(w, {"tokens": tokens}, harness.program_config(conf),
                         mode="train")
    got = model.logits_at(w, tokens, torch.arange(300), conf)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", CONFS)
def test_loss_and_grads_match_the_port(kind):
    from repro_torch.train.step import build_loss_fn, loss_and_grads
    conf = CONFS[kind]
    w = _weights(conf)
    batch = {k: torch.from_numpy(a).long() for k, a in
             train_batch(5, 0, 2, 96, conf["vocab_size"]).items()}
    loss, _, grads = loss_and_grads(
        build_loss_fn(harness.program_config(conf)), w, batch)
    params = {k: v.clone().requires_grad_() for k, v in w.items()}
    ref = model.loss(params, batch, conf)
    ref_grads = torch.autograd.grad(ref, list(params.values()))
    assert abs(float(ref.detach()) - float(loss)) < 1e-5
    for k, g in zip(params, ref_grads):
        scale = float(g.abs().max())
        assert float((grads[k] - g).abs().max()) <= 1e-4 * scale + 1e-7, k


def test_chunked_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(1)
    B, S, H, P, N = 2, 300, 3, 4, 5
    x = torch.randn(B, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, S, H, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    Bm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(B, S, N, generator=g, dtype=torch.float64)
    h = torch.zeros(B, H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        want.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    got = model.ssd(x, dt, A, Bm, Cm, chunk=64)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-10, atol=1e-10)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    err8 = float((model._RoundFP8.apply(x) - x).abs().max())
    err16 = float((x.bfloat16().float() - x).abs().max())
    assert err8 > 4 * err16
