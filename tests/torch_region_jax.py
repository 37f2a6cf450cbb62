"""The JAX side of the port's region-layer parity tests.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_region_jax.py {region|models} OUT.npz

``region``: for every case of ``torch_region_cases.layer_cases`` the global
forward and the gradients of ``sum(y ** 2)``, keyed ``<case>/fx`` and
``<case>/g<i>``, each case one jitted program; and the policy facts of
every mesh (``policy/<mesh>``, JSON).  ``models``: first the reference's
own LeNet-5 and sublayer parameters and LeNet's data, written at once to
``torch_region_cases.params_path(OUT)`` for the port's ranks; then LeNet
on the 2x2 mesh (the forward, the grads, five SGD steps' losses) and the
dense sublayer of TestFusedTransformerSublayer (forward and grads with
``policy=None``).
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

import torch_region_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.core import layers as L, overlap  # noqa: E402
from repro.core.compile import dist_jit  # noqa: E402
from repro.sharding import Partitioned, Policy  # noqa: E402

NS = SimpleNamespace(L=L, overlap=overlap, dist_jit=dist_jit,
                     Partitioned=Partitioned, Policy=Policy, P=PartitionSpec)


def mesh(shape, axes):
    return compat.make_mesh(shape, axes)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def run_region(out):
    meshes = {k: mesh(*v) for k, v in C.MESHES.items()}
    for cid, case in C.layer_cases().items():
        f = case["body"](NS, meshes[case["mesh"]])
        grads = case["grads"]

        @jax.jit
        def both(*a, f=f, grads=grads):
            if not grads:
                return f(*a), ()
            return f(*a), jax.grad(lambda *b: (f(*b) ** 2).sum(),
                                   argnums=grads)(*a)
        fx, gs = both(*[jnp.asarray(a) for a in case["inputs"]])
        out[f"{cid}/fx"] = np.asarray(fx)
        for i, g in zip(grads, gs):
            out[f"{cid}/g{i}"] = np.asarray(g)
    for name, (shape, axes) in C.POLICY_MESHES.items():
        out[f"policy/{name}"] = np.array(C.policy_facts(NS, mesh(shape, axes),
                                                        axes))
    out["boundary_errors"] = np.array(C.boundary_errors(NS, meshes["2d"]))


def init_models(path):
    """The reference's LeNet parameters and data (test_lenet_md.py's keys)
    and the sublayer's parameters, written to ``path`` at once, so the
    port's ranks start while the rest is computed."""
    from repro.configs import ModelConfig
    from repro.models.blocks import sublayer_init
    from repro.models.lenet import lenet_init, synthetic_mnist
    out = {}
    for name, key in (("lenet", 0), ("lenet_train", 4)):
        out.update({f"{name}/{k}": v for k, v in flat(
            lenet_init(jax.random.PRNGKey(key))).items()})
    for name, key, n in (("data", 1, 8), ("train_data", 5, 32)):
        x, y = synthetic_mnist(jax.random.PRNGKey(key), n)
        out[f"{name}/x"], out[f"{name}/y"] = np.asarray(x), np.asarray(y)
    params = sublayer_init(jax.random.PRNGKey(0), ModelConfig(**C.TP_CFG), 0,
                           jnp.float32)
    out.update({f"tp/{k}": v for k, v in flat(params).items()})
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def tree(flat_params, prefix):
    """The nested tree under ``prefix/`` of a flat ``{prefix/a.b: leaf}``."""
    out = {}
    for key, leaf in flat_params.items():
        if not key.startswith(prefix + "/"):
            continue
        *parents, name = key[len(prefix) + 1:].split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return out


def run_lenet(out, init):
    from repro.models.lenet import (lenet_apply_distributed,
                                    lenet_apply_sequential,
                                    table1_local_shapes)
    m = mesh(*C.MESHES["fofi"])
    params = tree(init, "lenet")
    x, y = jnp.asarray(init["data/x"]), jnp.asarray(init["data/y"])

    def xent(logits, y):
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(y.shape[0]),
                                                    y])

    def loss_d(p, x, y):
        return xent(lenet_apply_distributed(m, p, x), y)

    fwd = jax.jit(lambda p, x: lenet_apply_distributed(m, p, x))
    out["lenet/fx"] = np.asarray(fwd(params, x))
    out.update({f"lenet/grad/{k}": v for k, v in flat(
        jax.jit(jax.grad(loss_d))(params, x, y)).items()})
    out["lenet/table1"] = np.array(json.dumps(table1_local_shapes((2, 2))))
    # five SGD steps (test_lenet_md.py::test_short_training_equivalence)
    p = tree(init, "lenet_train")
    xt, yt = jnp.asarray(init["train_data/x"]), jnp.asarray(init["train_data/y"])
    step = jax.jit(jax.value_and_grad(loss_d))
    losses = []
    for _ in range(C.LENET_STEPS):
        loss, g = step(p, xt, yt)
        losses.append(float(loss))
        p = jax.tree_util.tree_map(lambda a, b: a - C.LENET_LR * b, p, g)
    out["lenet/train_losses"] = np.asarray(losses)
    out["lenet/seq_fx"] = np.asarray(jax.jit(lenet_apply_sequential)(params,
                                                                     x))


def run_tp(out, init):
    from repro.configs import ModelConfig
    from repro.models.blocks import sublayer_apply
    cfg = ModelConfig(**C.TP_CFG)
    params = tree(init, "tp")
    x, positions = (jnp.asarray(a) for a in C.tp_inputs())

    def fwd(p):
        return sublayer_apply(p, x, cfg, None, 0, positions=positions,
                              mode="train")[0]

    out["tp/fx"] = np.asarray(jax.jit(fwd)(params))
    grads = jax.jit(jax.grad(lambda p: (fwd(p).astype(jnp.float32) ** 2)
                             .sum()))(params)
    out.update({f"tp/grad/{k}": v for k, v in flat(grads).items()})


def main(argv):
    which, path = argv
    out = {}
    if which == "region":
        run_region(out)
    elif which == "models":
        init = init_models(C.params_path(path))
        run_lenet(out, init)
        run_tp(out, init)
    else:
        raise SystemExit(f"unknown case set {which!r}")
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
