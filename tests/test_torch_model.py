"""The port's model against the JAX model on the same parameters.

JAX initialises the parameters; ``params_from_jax`` carries them over leaf
by leaf as numpy.  Prefill logits and every cache leaf, then several decode
steps, must agree at 1e-4 in fp32: the reference's golden tolerance
(``tests/md/test_golden.py:11``).  reduced(glm4-9b) is the GQA dense
model; reduced(phi4-mini-3.8b) adds tied embeddings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention, forward, init_params
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.serve import ServeEngine

TOL = 1e-4
ARCHS = ["glm4-9b", "phi4-mini-3.8b"]


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = configs.reduced(configs.get_config(request.param))
    jcfg = jconfigs.reduced(jconfigs.get_config(request.param))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams))
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_copies(arch):
    """The port's configs, and reduced() on them, equal the reference's."""
    want = jconfigs.get_config(arch)
    got = configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(configs.reduced(got))
            == dataclasses.asdict(jconfigs.reduced(want)))


def test_converted_tree_covers_every_leaf(model):
    """Every JAX leaf lands once, under its key path, with its shape and
    dtype; the port's own init makes the same names and shapes."""
    cfg, _, jparams, params = model
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    names = {".".join(str(k.key) for k in path): leaf for path, leaf in leaves}
    assert len(params) == len(leaves) == len(names)
    assert set(params) == set(names)
    for name, leaf in names.items():
        assert tuple(params[name].shape) == leaf.shape, name
        assert str(params[name].dtype).endswith(str(leaf.dtype)), name
    own = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert sum(v.numel() for v in own.values()) == cfg.param_count()


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches(model, mode):
    cfg, jcfg, jparams, params = model
    tokens = _tokens(cfg, 2, 24, 1)
    jlogits, jcache, _ = jforward(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcfg, None, mode=mode)
    logits, cache, _ = forward(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, mode=mode)
    _close(logits, jlogits, msg="logits")
    if mode == "prefill":
        jcache = flatten(jax.device_get(jcache))
        assert set(cache) == set(jcache)
        for name, leaf in jcache.items():
            _close(cache[name], leaf, msg=name)


def test_prefill_and_decode_steps_match(model):
    """Teacher-forced decode through both engines: last-position logits and
    every (max-length) cache leaf after prefill and after each step."""
    cfg, jcfg, jparams, params = model
    B, S, steps, max_seq = 2, 12, 4, 24
    prompt = _tokens(cfg, B, S, 2)
    feed = _tokens(cfg, B, steps, 3)
    jeng = JaxServeEngine(jcfg, jparams, None, max_seq=max_seq, batch_size=B,
                          donate_cache=False)
    eng = ServeEngine(cfg, params, max_seq=max_seq, batch_size=B)

    jlogits, jcache = jeng.prefill(jnp.asarray(prompt))
    logits, cache = eng.prefill(torch.from_numpy(prompt).long())
    for t in range(steps + 1):
        _close(logits, jlogits, msg=f"logits after {t} decode steps")
        flat = flatten(jax.device_get(jcache))
        assert set(cache) == set(flat)
        for name, leaf in flat.items():
            _close(cache[name], leaf, msg=f"{name} after {t} decode steps")
        if t == steps:
            break
        tok = feed[:, t:t + 1]
        jlogits, jcache = jeng.decode_step(jcache, jnp.asarray(tok),
                                           jnp.int32(S + t))
        logits, cache = eng.decode_step(cache, torch.from_numpy(tok).long(),
                                        S + t)


@pytest.mark.parametrize("Sq,H,KH,chunk", [(64, 4, 2, 16), (100, 4, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_attention_matches_jax(Sq, H, KH, chunk, causal):
    """The second plain reference: the port's blockwise_attention against
    the JAX one (ragged last chunk included) and against attention_ref."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, Sq, n, 16)).astype(np.float32)
               for n in (H, KH, KH))
    want = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), chunk=chunk,
                                     causal=causal)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = attention.blockwise_attention(qt, kt, vt, chunk=chunk,
                                        causal=causal)
    _close(got, want, 2e-5)
    torch.testing.assert_close(got, attention_ref(qt, kt, vt, causal=causal),
                               atol=2e-5, rtol=2e-5)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
              for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.int32(13))
    got = attention.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 13)
    _close(got, want, 2e-5)


def test_unported_families_raise():
    for arch, what in [("kimi-k2-1t-a32b", "MoE"), ("mamba2-370m", "SSM")]:
        cfg = configs.reduced(configs.get_config(arch))
        with pytest.raises(NotImplementedError, match=what):
            init_params(cfg, torch.Generator().manual_seed(0), "cpu")
