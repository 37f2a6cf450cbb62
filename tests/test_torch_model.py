"""The port's model against the JAX model on the same parameters.

JAX initialises the parameters; ``params_from_jax`` carries them over leaf
by leaf as numpy.  Prefill logits and every cache leaf, then several decode
steps, must agree at 1e-4 in fp32: the reference's golden tolerance
(``tests/md/test_golden.py:11``).  reduced(glm4-9b) is the GQA dense
model; reduced(phi4-mini-3.8b) adds tied embeddings; reduced(mamba2-370m)
is the attention-free SSM model, whose caches are the conv and SSM states;
reduced(kimi-k2) and reduced(llama4-maverick) add MoE FFNs (every layer,
with a shared expert; every other layer, top-1), whose load-balance loss
must agree too.

reduced(jamba-v0.1-52b) (16 layers: SSM and attention mixers, MoE on odd
layers) is held layer by layer instead: in fp32 it amplifies a relative
change of 1e-7 in its embedding to more than the 1e-4 pin in its logits
(``test_jamba_end_to_end_amplifies_rounding``), so two correct
implementations that round in different orders cannot meet the pin end
to end.  Each of its 16 sublayers gets the same input on both sides (the
reference's output of the layer before) and must meet the pin in every
mode, caches and aux included, and in its vector-Jacobian product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models.blocks import sublayer_apply as jsublayer_apply
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention, blocks, forward, init_params
from repro_torch.models.blocks import sublayer_apply
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.serve import ServeEngine
from repro_torch.sharding import Policy

TOL = 1e-4
ARCHS = ["glm4-9b", "phi4-mini-3.8b", "mamba2-370m", "kimi-k2-1t-a32b",
         "llama4-maverick-400b-a17b"]
JAMBA = "jamba-v0.1-52b"


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
    jlogits, jcache, jaux = jforward(jparams, {"tokens": jnp.asarray(tokens)},
                                     jcfg, None, mode=mode)
    logits, cache, aux = forward(params, {"tokens": torch.from_numpy(tokens)},
                                 cfg, mode=mode)
    _close(logits, jlogits, msg="logits")
    _close(aux, jaux, msg="aux")
    assert (float(aux) > 0) == bool(cfg.num_experts)
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


@pytest.fixture(scope="module")
def jamba():
    cfg = configs.reduced(configs.get_config(JAMBA))
    jcfg = jconfigs.reduced(jconfigs.get_config(JAMBA))
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_jax(jax.device_get(jparams))


def _layers(cfg, jparams, params):
    """(s, i, JAX sublayer params, port sublayer params) of every layer in
    order: superblock s, position i."""
    for s in range(cfg.num_layers // cfg.block_period):
        for i in range(cfg.block_period):
            jp = jax.tree_util.tree_map(lambda a: a[s],
                                        jparams["blocks"][f"pos{i}"])
            p = {k[len(f"blocks.pos{i}."):]: v[s] for k, v in params.items()
                 if k.startswith(f"blocks.pos{i}.")}
            yield s, i, jp, p


def test_jamba_end_to_end_amplifies_rounding(jamba):
    """Why jamba is held layer by layer: the reference's own fp32 logits
    move by more than the pin when its embedding moves by 1e-7 relative,
    about one rounding of fp32."""
    _, jcfg, jparams, _ = jamba
    tokens = jnp.asarray(_tokens(jcfg, 2, 24, 1))
    base, _, _ = jforward(jparams, {"tokens": tokens}, jcfg, None)
    noise = jax.random.normal(jax.random.PRNGKey(5), jparams["embed"].shape)
    moved = dict(jparams, embed=jparams["embed"] * (1 + 1e-7 * noise))
    logits, _, _ = jforward(moved, {"tokens": tokens}, jcfg, None)
    assert float(jnp.abs(logits - base).max()) > TOL


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_jamba_sublayers_match_jax(jamba, mode):
    """Every sublayer of reduced jamba on the same input as the reference:
    output, aux and (prefill) cache entries at the pin; in decode, one
    step against the reference's prefill caches, the updated cache slices
    too."""
    cfg, jcfg, jparams, params = jamba
    B, S = 2, 12
    tokens = _tokens(cfg, B, S, 6)
    cache = cache_len = None
    if mode == "decode":
        jeng = JaxServeEngine(jcfg, jparams, None, max_seq=S + 4,
                              batch_size=B, donate_cache=False)
        _, jcache = jeng.prefill(jnp.asarray(tokens))
        cache = {k: torch.from_numpy(np.array(v)) for k, v in
                 flatten(jax.device_get(jcache)).items()}
        tokens, cache_len = _tokens(cfg, B, 1, 7), S
        jpos = jnp.full((B, 1), S, jnp.int32)
    else:
        jpos = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))
    x = jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0)
    for s, i, jp, p in _layers(cfg, jparams, params):
        where = f"{mode} superblock {s} pos {i}"
        sub = None
        if mode == "decode":
            jsub = jax.tree_util.tree_map(lambda a: a[s], jcache[f"pos{i}"])
            sub = {k[len(f"pos{i}."):]: v for k, v in cache.items()
                   if k.startswith(f"pos{i}.")}
        y_j, c_j, aux_j = jsublayer_apply(
            jp, x, jcfg, None, i, positions=jpos, mode=mode,
            cache=jsub if mode == "decode" else None,
            cache_len=jnp.int32(S) if mode == "decode" else None)
        y, kv, aux = sublayer_apply(
            p, torch.from_numpy(np.asarray(x)), cfg, i,
            positions=torch.from_numpy(np.asarray(jpos)).long(), mode=mode,
            cache=sub, index=s, cache_len=cache_len)
        _close(y, y_j, msg=f"{where} y")
        _close(aux, aux_j, msg=f"{where} aux")
        if mode == "prefill":
            assert set(kv) == set(c_j)
            for name in kv:
                _close(kv[name], c_j[name], msg=f"{where} {name}")
        elif mode == "decode":
            for name, leaf in c_j.items():
                _close(sub[name][s], leaf, msg=f"{where} {name}")
        x = y_j


def test_jamba_sublayer_vjps_match_jax(jamba):
    """The train-mode vector-Jacobian product of every sublayer of reduced
    jamba (the loss's path) on the same input and cotangents as the
    reference: the input's and every parameter's grad at the pin."""
    cfg, jcfg, jparams, params = jamba
    B, S = 2, 12
    rng = np.random.default_rng(8)
    x = jnp.take(jparams["embed"], jnp.asarray(_tokens(cfg, B, S, 9)),
                 axis=0)
    jpos = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))
    tpos = torch.from_numpy(np.asarray(jpos)).long()
    for s, i, jp, p in _layers(cfg, jparams, params):
        where = f"superblock {s} pos {i}"
        cot = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

        def f(pp, xx):
            y, _, aux = jsublayer_apply(pp, xx, jcfg, None, i,
                                        positions=jpos, mode="train")
            return y, aux
        (y_j, aux_j), vjp = jax.vjp(f, jp, x)
        jg_p, jg_x = vjp((jnp.asarray(cot), jnp.ones((), jnp.float32)))
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        xt = torch.from_numpy(np.asarray(x)).requires_grad_()
        y, _, aux = sublayer_apply(leaves, xt, cfg, i, positions=tpos,
                                   mode="train")
        roots, cots = [y], [torch.from_numpy(cot)]
        if aux.requires_grad:   # an MoE layer
            roots, cots = roots + [aux], cots + [torch.ones(())]
        grads = torch.autograd.grad(roots, list(leaves.values()) + [xt], cots,
                                    allow_unused=True, materialize_grads=True)
        _close(grads[-1], jg_x, msg=f"{where} grad x")
        jg_p = flatten(jax.device_get(jg_p))
        assert set(jg_p) == set(leaves)
        for name, g in zip(leaves, grads):
            _close(g, jg_p[name], msg=f"{where} grad {name}")
        x = y_j


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
    """What the port refuses raises naming why: sharded serving of widths
    the model axis does not divide (SSM mixers and MoE FFNs serve
    otherwise, ``test_torch_serve_mixers_md``).  The ``embeds``
    frontends serve now.  A pipeline stage over a live ctx axis rings
    attention, and refuses an SSM mixer there (the reference scans each
    shard from zero state).  MoE no longer raises: kimi's and jamba's
    parameters initialise."""
    cfg = configs.reduced(configs.get_config("glm4-9b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _, _ = forward(params, {"embeds": torch.zeros(1, 4, cfg.d_model)},
                           cfg)
    assert logits.shape == (1, 4, cfg.vocab_size)

    class Mesh:   # a mesh's shape, without a process group
        def __init__(self, names, shape):
            self.mesh_dim_names, self.shape = names, shape

        def size(self, dim):
            return self.shape[dim]

    jamba = configs.reduced(configs.get_config("jamba-v0.1-52b"))
    jp = init_params(jamba, torch.Generator().manual_seed(0), "cpu")
    serve_pol = Policy.for_mesh(Mesh(("data", "model"), (1, 16)))
    with pytest.raises(NotImplementedError, match="num_experts"):
        forward(jp, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, jamba,
                mode="prefill", policy=serve_pol)

    pol = Policy.for_mesh(Mesh(("data", "pipe", "ctx", "model"), (1, 1, 2, 1)))
    assert pol.active_ctx_axis == "ctx"
    p_stage = {k[len("blocks."):]: v for k, v in jp.items()
               if k.startswith("blocks.")}
    with pytest.raises(NotImplementedError, match="zero state"):
        blocks.pipeline_stage_body(p_stage, torch.zeros(1, 4, jamba.d_model),
                                   jamba, pol, positions=None)
    for arch in ("kimi-k2-1t-a32b", "jamba-v0.1-52b", "mamba2-370m"):
        cfg = configs.reduced(configs.get_config(arch))
        own = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert sum(v.numel() for v in own.values()) == cfg.param_count()
