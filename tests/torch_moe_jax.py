"""The JAX side of the port's expert-parallel parity test.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_moe_jax.py OUT.npz

First the reference's own MoE parameters (``p/*``, and ``p8/*`` for the
eight-expert leg), the inputs of every case (``x/<case>``) and the hybrid
cases' pipeline parameters and batch (``hybrid/*``), drawn with
tests/md/test_moe_md.py's keys and written at once to
``torch_region_cases.params_path(OUT)``; then every case of that file:
``moe_apply`` over the (data, model) = (2, 4) mesh and without a policy,
forward and the grads of ``sum(y ** 2) + 0.01 aux``, the capacity-0.5 run,
the per-block drop set on ``ep`` = 4, the eight-expert leg on ``ep`` = 8,
and the hybrid executor's loss and grads on the single-device,
(dp, ep) = (2, 4) and (ep, tp) = (4, 2) meshes.
"""

from __future__ import annotations

import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_moe_cases as C  # noqa: E402
import torch_region_cases as RC  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro.launch.mesh import make_hybrid_mesh  # noqa: E402
from repro.models import init_pipeline_params  # noqa: E402
from repro.models.moe import moe_apply, moe_init  # noqa: E402
from repro.sharding import Policy  # noqa: E402
from repro.train import build_hybrid_value_and_grad  # noqa: E402


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(d):
    tree = {}
    for k, v in d.items():
        node = tree
        *path, last = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return tree


def configs():
    cfg = dataclasses.replace(reduced(get_config(C.ARCH)),
                              capacity_factor=C.CAPACITY)
    tight = dataclasses.replace(cfg, capacity_factor=C.TIGHT)
    tight1 = dataclasses.replace(tight, experts_per_token=1,
                                 num_shared_experts=0)
    big = dataclasses.replace(cfg, num_experts=C.BIG_E, capacity_factor=8.0)
    return cfg, tight, tight1, big


def init(path):
    cfg, _, _, big = configs()
    out = {}
    out.update({f"p/{k}": v for k, v in flat(moe_init(
        jax.random.PRNGKey(0), cfg, jnp.float32)).items()})
    out.update({f"p8/{k}": v for k, v in flat(moe_init(
        jax.random.PRNGKey(0), big, jnp.float32)).items()})
    for case, (B, S) in C.X_SHAPE.items():
        out[f"x/{case}"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(C.X_KEY[case]), (B, S, cfg.d_model)))
    hcfg = ModelConfig(**C.HYBRID_CFG)
    out.update({f"hybrid/params/{k}": v for k, v in flat(
        init_pipeline_params(hcfg, jax.random.PRNGKey(0), 1)).items()})
    key = jax.random.PRNGKey(7)
    shape = (C.HYBRID_BATCH, C.HYBRID_SEQ)
    out["hybrid/tokens"] = np.asarray(jax.random.randint(
        key, shape, 0, hcfg.vocab_size))
    out["hybrid/labels"] = np.asarray(jax.random.randint(
        jax.random.fold_in(key, 1), shape, 0, hcfg.vocab_size))
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def run_moe(out, init_out):
    cfg, tight, tight1, big = configs()
    p = unflat(C.subtree(init_out, "p"))
    x = {case: jnp.asarray(init_out[f"x/{case}"]) for case in C.X_SHAPE}
    pol2d = Policy(mesh=compat.make_mesh((2, 4), ("data", "model")))
    pol_ep4 = Policy.for_mesh(compat.make_mesh((4,), ("ep",)))
    pol_ep8 = Policy.for_mesh(compat.make_mesh((8,), ("ep",)))

    def apply(xx, pp, c, pol):
        # one jitted program a call: op-by-op shard_map takes minutes
        return jax.jit(lambda a, b: moe_apply(a, b, c, pol))(xx, pp)

    for name, pol in (("ep", pol2d), ("ref", None)):
        out[f"fwd/{name}/y"], out[f"fwd/{name}/aux"] = apply(x["fwd"], p, cfg,
                                                             pol)

        def loss(pp, pol=pol):
            y, aux = moe_apply(x["grads"], pp, cfg, pol)
            return (y ** 2).sum() + C.AUX_WEIGHT * aux
        out.update({f"grads/{name}/{k}": v for k, v in
                    flat(jax.jit(jax.grad(loss))(p)).items()})
    out["drops/y"] = apply(x["drops"], p, tight, pol2d)[0]
    out["drop_set/ep"] = apply(x["drop_set"], p, tight1, pol_ep4)[0]
    out["drop_set/ref"] = jnp.concatenate(
        [apply(x["drop_set"][2 * i:2 * (i + 1)], p, tight1, None)[0]
         for i in range(4)])
    p8 = unflat(C.subtree(init_out, "p8"))
    out["big_e/ep"] = apply(x["big_e"], p8, big, pol_ep8)[0]
    out["big_e/ref"] = apply(x["big_e"], p8, big, None)[0]


def run_hybrid(out, init_out):
    cfg = ModelConfig(**C.HYBRID_CFG)
    params = unflat(C.subtree(init_out, "hybrid/params"))
    M = C.HYBRID_M
    mbs = {k: jnp.asarray(init_out[f"hybrid/{k}"]).reshape(
        (M, C.HYBRID_BATCH // M, C.HYBRID_SEQ)) for k in ("tokens", "labels")}
    for name, (dp, S, cp, tp, ep) in C.HYBRID_MESHES.items():
        pol = Policy.for_mesh(make_hybrid_mesh(dp, S, cp=cp, tp=tp, ep=ep),
                              explicit_tp=True)
        pvg, _ = build_hybrid_value_and_grad(cfg, pol, num_microbatches=M)
        loss, grads = jax.jit(pvg)(params, {"tokens": mbs["tokens"]},
                                   mbs["labels"])
        out[f"hybrid/{name}/loss"] = loss
        out.update({f"hybrid/{name}/grad/{k}": v
                    for k, v in flat(grads).items()})


def main(argv):
    (path,) = argv
    init_out = init(RC.params_path(path))
    out = {}
    run_moe(out, init_out)
    run_hybrid(out, init_out)
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1:])
