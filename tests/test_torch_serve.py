"""The port's serving engine and CLI against the JAX serving engine.

Same parameters (initialised by JAX, carried over as numpy) and the same
prompt: greedy tokens must be identical.  The CLI runs on the host only
when asked (``--device cpu``); without a card and without that flag it
raises rather than falling back.
"""

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
from repro.models import init_params as jinit_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.device import NO_CARD
from repro_torch.launch import serve
from repro_torch.models import forward, init_params
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module", params=["glm4-9b", "phi4-mini-3.8b"])
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
    tests/test_serve.py)."""
    cfg, params, _, eng = engines
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


def test_cli_on_host_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--steps", "4"],
        env=env, capture_output=True, text=True, timeout=300)
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
