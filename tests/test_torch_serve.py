"""The port's serving engine and CLI against the JAX serving engine.

Same parameters (initialised by JAX, carried over as numpy) and the same
prompt: greedy tokens must be identical.  The stub frontends (reduced
pixtral-12b and musicgen-medium) prefill from ``{"embeds"}`` and decode 4
tokens against the reference's ``forward``, logits within 1e-4 of scale.
The CLI runs on the host only when asked (``--device cpu``); without a
card and without that flag it raises rather than falling back; its
``--ckpt-dir`` restores a checkpoint the reference wrote, bitwise.
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
from repro.checkpoint import ckpt as jckpt
from repro.models import init_params as jinit_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.device import NO_CARD
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module",
                params=["glm4-9b", "phi4-mini-3.8b", "mamba2-370m",
                        "jamba-v0.1-52b", "kimi-k2-1t-a32b",
                        "llama4-maverick-400b-a17b"])
def engines(request):
    cfg = configs.reduced(configs.get_config(request.param))
    jcfg = jconfigs.reduced(jconfigs.get_config(request.param))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.device_get(jparams))
    jeng = JaxServeEngine(jcfg, jparams, None, max_seq=64, batch_size=2)
    eng = ServeEngine(cfg, params, max_seq=64, batch_size=2)
    return cfg, params, jeng, eng


def _prompt(cfg, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S),
                                                dtype=np.int32)


def test_greedy_tokens_identical_to_jax(engines):
    cfg, _, jeng, eng = engines
    prompt = _prompt(cfg, 16, 2)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), steps=8))
    got = eng.generate(torch.from_numpy(prompt).long(), steps=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_matches_teacher_forcing(engines):
    """Greedy generation agrees with argmax over a full forward pass on the
    generated prefix (cache correctness end to end; mirrors
    tests/test_serve.py).  An MoE model runs with a capacity no expert can
    overflow: a decode step routes B tokens and the full pass B x S, so
    capacity drops (the reference's semantics, held against JAX above)
    would differ between the two by design."""
    cfg, params, _, eng = engines
    if cfg.num_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
        eng = ServeEngine(cfg, params, max_seq=64, batch_size=2)
    prompt = torch.from_numpy(_prompt(cfg, 16, 3)).long()
    out = eng.generate(prompt, steps=8)
    assert out.shape == (2, 8)
    logits, _, _ = forward(params, {"tokens": torch.cat([prompt, out], 1)},
                           cfg, mode="train")
    for t in range(8):
        assert torch.equal(out[:, t], logits[:, 16 + t - 1].argmax(-1))
    assert eng.stats["logits_finite"]


def test_sampling_path(engines):
    cfg, _, _, eng = engines
    prompt = torch.from_numpy(_prompt(cfg, 8, 4)).long()
    gen = torch.Generator().manual_seed(0)
    out = eng.generate(prompt, steps=4, greedy=False, generator=gen,
                       temperature=0.8)
    assert out.shape == (2, 4)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    again = eng.generate(prompt, steps=4, greedy=False,
                         generator=torch.Generator().manual_seed(0),
                         temperature=0.8)
    assert torch.equal(out, again)


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--reduced", "--device", "cpu", "--steps", "4"],
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_on_host_exits_zero():
    proc = _run_cli()
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 4) on cpu" in proc.stdout


def test_cli_on_host_serves_mamba2():
    proc = _run_cli("--arch", "mamba2-370m")
    assert proc.returncode == 0, proc.stderr
    assert "generated (4, 4) on cpu" in proc.stdout


def test_no_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--steps", "4"])
    cfg = configs.reduced(configs.get_config("glm4-9b"))
    with pytest.raises(RuntimeError, match=NO_CARD.split(":")[0]):
        init_params(cfg, torch.Generator())


@pytest.mark.parametrize("arch", ["pixtral-12b", "musicgen-medium"])
def test_embeds_frontend_prefill_and_decode_match_jax(arch):
    """``{"embeds": (B, S, d)}`` in place of tokens (cast to cfg.dtype, no
    lookup), then greedy decode from tokens, against the reference's
    ``forward`` in both modes on the same parameters."""
    cfg = configs.reduced(configs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    assert cfg.frontend != "none"
    jparams = jinit_params(jcfg, jax.random.PRNGKey(4))
    params = params_from_jax(jax.device_get(jparams))
    B, S, max_seq = 2, 12, 24
    emb = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jeng = JaxServeEngine(jcfg, jparams, None, max_seq=max_seq, batch_size=B)
    want, jcache = jeng._prefill_impl(jparams, {"embeds": jnp.asarray(emb)})
    logits, pref, _ = forward(params, {"embeds": torch.from_numpy(emb)}, cfg,
                              mode="prefill")
    eng = ServeEngine(cfg, params, max_seq=max_seq, batch_size=B)
    cache = init_cache(cfg, B, max_seq, device="cpu")
    for name, leaf in pref.items():
        cache[name][:, :, :S] = leaf
    got = logits[:, -1]
    for t in range(5):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4 * scale, rtol=0,
                                   err_msg=f"{arch} step {t}")
        tok = np.asarray(jnp.argmax(want, axis=-1))[:, None]
        assert np.array_equal(got.argmax(-1).numpy()[:, None], tok), t
        if t == 4:
            break
        want, jcache = jeng.decode_step(jcache, jnp.asarray(tok, jnp.int32),
                                        jnp.int32(S + t))
        got, cache = eng.decode_step(cache, torch.tensor(tok).long(),
                                     S + t)


def test_cli_restores_a_reference_checkpoint_bitwise(tmp_path, capsys):
    """The reference's ``checkpoint.save`` writes reduced glm4-9b's params
    (its own init at seed 7); the port's CLI restores them with
    ``--ckpt-dir`` (its own init at seed 0 underneath): every leaf bitwise
    the reference's restore, and the greedy tokens of both engines on one
    numpy prompt equal (the two CLIs draw their prompts from different
    generators, so the engines are compared)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("glm4-9b"))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(7))
    jckpt.save(str(tmp_path), 5, {"params": jparams, "step": jnp.int32(5),
                                  "opt": None})
    jstate, jstep = jckpt.restore(
        str(tmp_path), like={"params": jparams, "step": jnp.int32(0),
                             "opt": None})
    assert jstep == 5
    out = serve.main(["--reduced", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path), "--steps", "4"])
    assert "restored params from step 5" in capsys.readouterr().out
    engine = out["engine"]
    want = params_from_jax(jax.device_get(jstate["params"]))
    assert sorted(engine.params) == sorted(want)
    for k, v in want.items():
        assert torch.equal(engine.params[k], v), k
    prompt = _prompt(jcfg, 16, 6)
    jeng = JaxServeEngine(jcfg, jstate["params"], None, max_seq=64,
                          batch_size=2)
    want_tok = np.asarray(jeng.generate(jnp.asarray(prompt), steps=8))
    eng = ServeEngine(engine.cfg, engine.params, max_seq=64, batch_size=2)
    got = eng.generate(torch.from_numpy(prompt).long(), steps=8)
    np.testing.assert_array_equal(got.numpy(), want_tok)


def test_cli_without_a_checkpoint_initialises_fresh(tmp_path, capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "empty"), "--steps", "2"])
    assert "restored" not in capsys.readouterr().out
    assert out["tokens"].shape == (4, 2)
