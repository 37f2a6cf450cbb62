"""The port's MoE layer (``models/moe.py``) against the JAX package's, in
one process on the same numpy draws: the local dispatch/combine forward
and its grads, the dropped-token set at capacity 0.5, ``moe_apply``
without a policy and ``moe_stage_body`` with the shared expert.  fp32 at
the model tests' pin (1e-4); drop sets and top-k choices exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax

TOL = 1e-4
ARCHS = ["jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=tol,
                               rtol=tol, err_msg=msg)


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                **kw),
            dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                                **kw))


def _params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.device_get(jp))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _jexperts(p):
    def expert_fn(disp):
        h = jnp.einsum("ecd,edh->ech", disp, p["we_up"])
        g = jnp.einsum("ecd,edh->ech", disp, p["we_gate"])
        return jnp.einsum("ech,ehd->ecd", jax.nn.silu(g) * h, p["we_down"])
    return expert_fn


def _texperts(p):
    return lambda disp: moe.expert_ffn(disp, p["we_up"], p["we_gate"],
                                       p["we_down"])


def test_moe_init_leaves_match_jax():
    """Same leaf names, shapes and dtypes as the reference's init, the
    shared expert under ``shared.``; stacked leaves lead with the stack."""
    for arch in ARCHS:
        cfg, jcfg = _cfgs(arch)
        _, want = _params(jcfg)
        own = moe.moe_init(cfg, torch.float32,
                           torch.Generator().manual_seed(0), stacked=3)
        assert {k: (3,) + tuple(v.shape) for k, v in want.items()} == {
            k: tuple(v.shape) for k, v in own.items()}, arch
        assert own["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", [1.25, 0.5])
def test_dispatch_combine_local_matches_jax(arch, capacity):
    """y, aux and the grads of ``sum(y * c) + aux`` for x, the router and
    the three expert weights; at capacity 0.5 tokens drop."""
    cfg, jcfg = _cfgs(arch, capacity_factor=capacity)
    jp, p = _params(jcfg)
    x = _x(cfg, (48,), 1)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        y, aux = jmoe._dispatch_combine_local(xx, pp["router"], jcfg,
                                              _jexperts(pp))
        return (y * cot).sum() + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    leaves = {k: p[k].clone().requires_grad_() for k in
              ("router",) + moe.EXPERT_LEAVES}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe._dispatch_combine_local(xt, leaves["router"], cfg,
                                         _texperts(leaves))
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum() + aux,
                                [xt] + list(leaves.values()))
    _close(grads[0], jgx, "grad x")
    for (k, _), g in zip(leaves.items(), grads[1:]):
        _close(g, jg[k], f"grad {k}")


def test_drop_set_at_capacity_half_matches_jax():
    """k = 1 (the gate is then exactly 1), capacity 0.5: the rows that
    combine to exactly zero, the dropped tokens, are the reference's, and
    the stable slot order drops the later tokens of each over-full
    expert."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b", capacity_factor=0.5,
                      experts_per_token=1, num_shared_experts=0)
    jp, p = _params(jcfg)
    x = _x(cfg, (64,), 3)
    jy, _ = jmoe._dispatch_combine_local(jnp.asarray(x), jp["router"], jcfg,
                                         _jexperts(jp))
    y, _ = moe._dispatch_combine_local(torch.from_numpy(x), p["router"], cfg,
                                       _texperts(p))
    dropped = np.all(np.asarray(jy) == 0.0, axis=-1)
    np.testing.assert_array_equal(np.all(y.numpy() == 0.0, axis=-1), dropped)
    assert 0 < dropped.sum() < len(dropped)
    _close(y, jy)
    # the plan: the first cap choices of each expert, in token order
    probs = torch.softmax(torch.from_numpy(x) @ p["router"], dim=-1)
    choice = probs.argmax(-1, keepdim=True)
    cap = math.ceil(64 / cfg.num_experts * 0.5)
    order, slot, keep, tok, counts = moe.dispatch_plan(choice,
                                                       cfg.num_experts, cap)
    for e in range(cfg.num_experts):
        mine = torch.nonzero(choice[:, 0] == e)[:, 0]
        assert torch.equal(tok[keep & (slot // cap == e)], mine[:cap])
    assert torch.equal(torch.sort(tok[~keep]).values,
                       torch.from_numpy(np.nonzero(dropped)[0]))
    assert int(counts.sum()) == 64 and bool((slot[~keep]
                                             == cfg.num_experts * cap).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_without_policy_matches_jax(arch):
    """The reference path (no policy), the shared expert included where
    the arch has one (kimi, llama4)."""
    cfg, jcfg = _cfgs(arch)
    jp, p = _params(jcfg, seed=4)
    x = _x(cfg, (2, 24), 5)
    jy, jaux = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, None)
    y, aux = moe.moe_apply(torch.from_numpy(x), p, cfg, None)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    assert ("shared.w_up" in p) == bool(cfg.num_shared_experts)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_stage_body_with_shared_expert_matches_jax(arch):
    """The executor's body form outside any mesh axis (ep and the
    statistics' axes absent): y, aux and the grads of every leaf."""
    cfg, jcfg = _cfgs(arch)
    assert cfg.num_shared_experts
    jp, p = _params(jcfg, seed=6)
    x = _x(cfg, (2, 12), 7)

    def jloss(pp):
        y, aux = jmoe.moe_stage_body(jnp.asarray(x), pp, jcfg)
        return (y ** 2).sum() + 0.01 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, aux = moe.moe_stage_body(torch.from_numpy(x), leaves, cfg)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    grads = torch.autograd.grad((y ** 2).sum() + 0.01 * aux,
                                list(leaves.values()))
    jg = params_from_jax(jax.device_get(jg))
    for (k, _), g in zip(leaves.items(), grads):
        _close(g, jg[k], f"grad {k}")


def test_expert_split_must_divide():
    cfg, _ = _cfgs("jamba-v0.1-52b")
    moe._check_expert_split(cfg, 4, "ep")
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        moe._check_expert_split(cfg, 3, "ep")
