"""The JAX side of the port's policy-train-program parity test.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_zero3_jax.py {glm|mamba|kimi} OUT.npz

First the parameters of the archs of its cases (``CHILDREN``), written at
once to ``torch_region_cases.params_path(OUT)`` as ``<arch>/<key>``.
Then, for each case, the jitted ``build_train_step`` on the case's mesh
under ``Policy(mesh)`` (the reference's defaults: fsdp and seq_shard on),
the parameters placed by ``param_shardings``, run for two steps (one
program, called twice), and on ``GRADS_CASES`` first the jitted loss and
gradients of ``build_loss_fn`` on the first batch: ``<case>/loss``,
``<case>/grads/<key>``, ``<case>/step{1,2}/{loss,grad_norm,skipped}``,
``<case>/params/<key>``, ``<case>/m/<key>``, ``<case>/v/<key>``,
``<case>/count``.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_region_cases as RC  # noqa: E402
import torch_zero3_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro.sharding import Policy  # noqa: E402
from repro.train import build_train_step, init_train_state  # noqa: E402
from repro.train.step import build_loss_fn  # noqa: E402


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def config(model):
    return C.model_config(model, get_config, reduced)


def main(argv):
    which, path = argv
    cases = C.CHILDREN[which]
    archs = sorted({C.CASES[c][0] for c in cases})
    params = {a: jax.jit(init_params, static_argnums=0)(
        config(a), jax.random.PRNGKey(C.PARAMS_SEED)) for a in archs}
    init = {f"{a}/{k}": v for a in archs
            for k, v in flat(params[a]).items()}
    tmp = f"{RC.params_path(path)}.tmp.npz"
    np.savez(tmp, **init)
    os.replace(tmp, RC.params_path(path))

    out = {}
    for case in cases:
        arch, shape = C.CASES[case]
        cfg = config(arch)
        mesh = compat.make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        pol = Policy(mesh)
        opt = make_optimizer(cfg.optimizer, total_steps=C.TOTAL_STEPS,
                             base_lr=C.LR)
        step = build_train_step(cfg, pol, opt)
        loss_fn = build_loss_fn(cfg, pol)
        b1, b2 = ({k: jnp.asarray(v) for k, v in b.items()}
                  for b in C.batches(cfg.vocab_size))

        p = jax.device_put(params[arch], pol.param_shardings(params[arch]))
        state = init_train_state(cfg, p, opt)
        if case in C.GRADS_CASES:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(p, b1)
            out[f"{case}/loss"] = np.asarray(loss)
            for k, v in flat(jax.device_get(grads)).items():
                out[f"{case}/grads/{k}"] = v
        # one compile: the second step's state is placed as the first's
        jstep = jax.jit(step).lower(state, b1).compile()
        s1, m1 = jstep(state, b1)
        s2, m2 = jstep(jax.device_put(s1, jstep.input_shardings[0][0]), b2)
        for i, m in ((1, m1), (2, m2)):
            for k in ("loss", "grad_norm", "skipped"):
                out[f"{case}/step{i}/{k}"] = np.asarray(m[k])
        for part, tree in (("params", s2["params"]), ("m", s2["opt"]["m"]),
                           ("v", s2["opt"]["v"])):
            for k, v in flat(jax.device_get(tree)).items():
                out[f"{case}/{part}/{k}"] = v.astype(np.float32)
        out[f"{case}/count"] = np.asarray(s2["opt"]["count"])
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
