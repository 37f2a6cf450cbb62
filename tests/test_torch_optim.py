"""The port's optimizers, gradient utilities and non-finite guard against the
JAX package's, on the same trees.

Trees are made with numpy from a seed and handed to both packages.  Updates
run a few steps with a clip ``scale`` folded in; params and moments must
agree at 1e-6 in fp32 (the same float32 expressions on both sides) and to
one bf16 rounding where a leaf is stored in bf16.  Stochastic rounding
draws torch's bits, not threefry's, so it is held to its distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.resilience import guard as jguard
from repro_torch.models.convert import flatten, to_tensor
from repro_torch.optim import optimizers as opt
from repro_torch.resilience import guard

SHAPES = {            # a 2-D matrix, a stacked (n_super, d) norm, a vector
    "blocks.w": (2, 16, 24),
    "blocks.norm": (2, 16),
    "embed": (40, 16),
    "norm_final": (16,),
}


def _tree(seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(dtype)
            for k, s in SHAPES.items()}


def _torch(tree, dtype=None):
    return {k: to_tensor(v) if dtype is None else to_tensor(v).to(dtype)
            for k, v in tree.items()}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("base_lr,warmup,total", [
    (3e-4, 500, 10_000), (1e-3, 2, 5), (1e-3, 1, 1), (0.1, 10, 40)])
def test_warmup_cosine_matches_jax(base_lr, warmup, total):
    want = jopt.warmup_cosine(base_lr, warmup, total)
    got = opt.warmup_cosine(base_lr, warmup, total)
    for step in sorted({0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 7}):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_global_norm_and_clip_match_jax():
    """Mixed dtypes, as the model's grads are (bf16 matrices, fp32 norms):
    each leaf is upcast before squaring."""
    tree = _tree(0, 3.0)
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["embed"] = jtree["embed"].astype(jnp.bfloat16)
    ttree = _torch(tree)
    ttree["embed"] = ttree["embed"].to(torch.bfloat16)
    np.testing.assert_allclose(float(opt.global_norm(ttree)),
                               float(jopt.global_norm(jtree)), rtol=1e-6)
    for max_norm in (1.0, 1e3):
        clipped, norm = opt.clip_by_global_norm(ttree, max_norm)
        jclipped, jnorm = jopt.clip_by_global_norm(jtree, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for k in tree:
            assert clipped[k].dtype == ttree[k].dtype
            _close(clipped[k], jclipped[k], 1e-6 if k != "embed" else 1e-2, k)


def test_compress_grads_deterministic_matches_jax_bitwise():
    tree = _tree(1)
    got = opt.compress_grads(_torch(tree))
    want = jopt.compress_grads({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(),
            np.asarray(want[k]).view(np.int16))


def test_compress_grads_stochastic_is_unbiased():
    """Each value rounds to one of its two bf16 neighbours (the truncation
    of x and the next bf16 away from 0), with mean x: over 4000 draws the
    mean is within 5 standard errors of x, while round-to-nearest is off by
    up to half a bf16 step."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(64)
                         .astype(np.float32))
    draws = 4000
    gen = torch.Generator().manual_seed(0)
    got = opt.compress_grads({"g": x.expand(draws, 64).contiguous()},
                             generator=gen)["g"].float()
    lo = (x.view(torch.int32) & ~0xFFFF).view(torch.float32)
    hi = ((x.view(torch.int32) & ~0xFFFF) + 0x10000).view(torch.float32)
    assert bool(((got == lo) | (got == hi)).all())
    step = (hi - lo).abs()
    frac = (x - lo).abs() / step
    se = step * torch.sqrt(frac * (1 - frac) / draws)
    assert bool(((got.mean(0) - x).abs() <= 5 * se + 1e-12).all())
    nearest_err = (x.to(torch.bfloat16).float() - x).abs()
    assert float(nearest_err.max()) > 10 * float(se.max())
    with pytest.raises(NotImplementedError):
        opt.compress_grads({"g": x}, dtype=torch.float16, generator=gen)


def _run_updates(make, param_dtype, steps=3):
    """``steps`` updates of the port's and JAX's optimizer on the same
    params and grads; returns both (params, state)."""
    lr = opt.warmup_cosine(1e-2, 2, 10)
    jlr = jopt.warmup_cosine(1e-2, 2, 10)
    tparams = _torch(_tree(3), param_dtype)
    jparams = {k: jnp.asarray(v).astype(jnp.dtype(str(param_dtype)[6:]))
               for k, v in _tree(3).items()}
    topt, jo = make(opt, lr), make(jopt, jlr)
    tstate, jstate = topt.init(tparams), jo.init(jparams)
    for i in range(steps):
        grads = _tree(10 + i, 0.1)
        if i == 1:
            grads["blocks.w"][0, 0, 0] = 0.0   # a zero grad element
        scale = np.float32(0.5) if i == 2 else None
        tparams, tstate = topt.update(
            _torch(grads), tstate, tparams,
            scale=None if scale is None else torch.tensor(scale))
        jparams, jstate = jo.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams,
            scale=None if scale is None else jnp.asarray(scale))
    return (tparams, tstate), (jparams, jstate)


OPTIMIZERS = {
    "adamw": lambda mod, lr: mod.AdamW(lr=lr),
    "adamw_bf16": lambda mod, lr: mod.AdamW(
        lr=lr, moment_dtype=(torch.bfloat16 if mod is opt else jnp.bfloat16)),
    "adafactor": lambda mod, lr: mod.Adafactor(lr=lr),
    "adafactor_wd": lambda mod, lr: mod.Adafactor(lr=lr, weight_decay=0.1),
}


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_optimizer_updates_match_jax(kind, param_dtype):
    """Params, every moment leaf (Adafactor's row and column statistics
    included) and ``count`` after three updates.  A leaf stored in bf16 may
    differ by one bf16 rounding (2^-8 relative) where the fp32 values sit
    on a rounding boundary."""
    (tparams, tstate), (jparams, jstate) = _run_updates(OPTIMIZERS[kind],
                                                        param_dtype)
    assert tstate["count"] == int(jstate["count"]) == 3
    p_tol = 1e-6 if param_dtype == torch.float32 else 2 ** -8
    for k in SHAPES:
        assert tparams[k].dtype == param_dtype
        _close(tparams[k], jparams[k], p_tol, f"param {k}")
    m_tol = 1e-6 if tstate["m"]["embed"].dtype == torch.float32 else 2 ** -8
    for k, leaf in flatten(jax.device_get(jstate["m"])).items():
        _close(tstate["m"][k], leaf, m_tol, f"m {k}")
    v_tol = 1e-6 if kind != "adamw_bf16" else 2 ** -8
    want_v = flatten(jax.device_get(jstate["v"]))
    got_v = flatten(tstate["v"])
    assert set(got_v) == set(want_v)
    for k, leaf in want_v.items():
        _close(got_v[k], leaf, v_tol, f"v {k}")


def test_adamw_decays_every_leaf_of_two_or_more_dims():
    """Decoupled weight decay hits the matrices and the stacked (n_super,
    d) norms, and not the (d,) final norm: with zero grads only decayed
    leaves move."""
    params = _torch(_tree(4))
    before = {k: v.clone() for k, v in params.items()}
    adamw = opt.AdamW(lr=lambda count: 0.1)
    params, _ = adamw.update({k: torch.zeros_like(v) for k, v in
                              params.items()}, adamw.init(params), params)
    for k, v in params.items():
        moved = not torch.equal(v, before[k])
        assert moved == (v.ndim >= 2), k
        if moved:
            torch.testing.assert_close(v, before[k] * (1 - 0.1 * 0.1))


def test_make_optimizer_kinds():
    assert isinstance(opt.make_optimizer("adamw"), opt.AdamW)
    assert opt.make_optimizer("adamw_bf16").moment_dtype == torch.bfloat16
    assert isinstance(opt.make_optimizer("adafactor"), opt.Adafactor)
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.make_optimizer("sgd")
    for total in (5, 10_000):
        want = jopt.make_optimizer("adamw", total_steps=total, base_lr=1e-3)
        got = opt.make_optimizer("adamw", total_steps=total, base_lr=1e-3)
        for count in (1, 2, total):
            np.testing.assert_allclose(got.lr(count),
                                       float(want.lr(jnp.int32(count))),
                                       rtol=1e-6)


@pytest.mark.parametrize("poison", [None, np.nan, np.inf, -np.inf])
def test_nonfinite_count_and_flag_match_jax(poison):
    tree = _tree(5)
    if poison is not None:
        tree["blocks.w"][1, 2, 3] = poison
        tree["norm_final"][0] = poison
    jtree = ({k: jnp.asarray(v) for k, v in tree.items()}, jnp.int32(7))
    ttree = (_torch(tree), torch.tensor(7, dtype=torch.int32))
    assert int(guard.nonfinite_count(ttree)) == int(
        jguard.nonfinite_count(jtree))
    assert int(guard.nonfinite_flag(ttree)) == int(
        jguard.nonfinite_flag(jtree)) == int(poison is not None)


def test_combine_flags_and_tree_where_match_jax():
    for flags in ((0, 0), (0, 1), (1, 0, 1)):
        assert int(guard.combine_flags(*map(torch.tensor, flags))) == int(
            jguard.combine_flags(*map(jnp.int32, flags)))
    new, old = _tree(6), _tree(7)
    new["embed"][0, 0] = np.nan        # the rejected branch's NaN
    for ok in (True, False):
        got = guard.tree_where(ok, _torch(new), _torch(old))
        want = jguard.tree_where(ok, {k: jnp.asarray(v) for k, v in
                                      new.items()},
                                 {k: jnp.asarray(v) for k, v in old.items()})
        for k in new:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        if not ok:
            assert bool(torch.isfinite(got["embed"]).all())


@pytest.mark.parametrize("flag", [0, 1])
def test_apply_guard_matches_jax(flag):
    """On a skip the previous params and moments come back (bitwise); the
    step advances either way; states without the counter default it to 0."""
    old, new = _tree(8), _tree(9)
    state = {"params": _torch(old), "opt": {"m": _torch(old)}, "step": 4}
    jstate = {"params": {k: jnp.asarray(v) for k, v in old.items()},
              "opt": {"m": {k: jnp.asarray(v) for k, v in old.items()}},
              "step": jnp.int32(4)}
    got = guard.apply_guard(flag, state, _torch(new), {"m": _torch(new)})
    want = jguard.apply_guard(jnp.int32(flag), jstate,
                              {k: jnp.asarray(v) for k, v in new.items()},
                              {"m": {k: jnp.asarray(v) for k, v in
                                     new.items()}})
    assert got["step"] == int(want["step"]) == 5
    assert got["skipped_steps"] == int(want["skipped_steps"]) == flag
    for k in old:
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(want["params"][k]))
        np.testing.assert_array_equal(got["opt"]["m"][k].numpy(),
                                      np.asarray(want["opt"]["m"][k]))
    if flag:
        assert got["params"] is state["params"]
