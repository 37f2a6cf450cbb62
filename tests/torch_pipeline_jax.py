"""The JAX side of the port's pipeline and hybrid parity tests.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_pipeline_jax.py {pipeline|hybrid} OUT.npz

Both first write the reference's own pipeline parameters
(``init_pipeline_params(CFG, PRNGKey(0), S)``, flat keys ``p<S>/pre.embed``,
``p<S>/stage.pos0.attn.wq``, ...) and the data of tests/md/test_pipeline.py
and tests/md/test_hybrid.py (``data/M<M>/{tokens,labels}``) to
``torch_region_cases.params_path(OUT)`` at once.  Then ``pipeline``: the
live executor (``pipeline_value_and_grad``) on every case of
``torch_pipeline_cases.PIPE_CASES``; ``hybrid``: on every case of
``HYBRID_CASES``, then two AdamW steps of ``build_hybrid_train_step`` on
the (2, 2, 2) mesh (``train/loss<i>``, ``train/grad_norm<i>``,
``train/params/<key>``).  Each case writes ``<case>/loss`` and
``<case>/grad/<key>`` (the global gradients).
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_pipeline_cases as C  # noqa: E402
import torch_region_cases as RC  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import ModelConfig  # noqa: E402
from repro.core.pipeline import (make_schedule,  # noqa: E402
                                 pipeline_value_and_grad)
from repro.launch.mesh import make_hybrid_mesh  # noqa: E402
from repro.models import (init_pipeline_params, pipeline_fns,  # noqa: E402
                          pipeline_param_parts)
from repro.sharding import Partitioned, Policy  # noqa: E402
from repro.train import cross_entropy  # noqa: E402

CFG = ModelConfig(**C.CFG)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(flat_params):
    """The nested ``{pre, stage, post}`` tree of flat ``a.b.c`` keys."""
    out = {}
    for key, leaf in flat_params.items():
        *parents, name = key.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return out


def data(M, B, L=C.SEQ, seed=1):
    """tests/md/test_{pipeline,hybrid}.py::_data."""
    key = jax.random.PRNGKey(seed)
    tokens = jax.random.randint(key, (B, L), 0, CFG.vocab_size)
    labels = jax.random.randint(jax.random.fold_in(key, 1), (B, L), 0,
                                CFG.vocab_size)
    return (np.asarray(tokens.reshape(M, B // M, L)),
            np.asarray(labels.reshape(M, B // M, L)))


def init(which, path):
    out = {}
    if which == "pipeline":
        stages = {C.PIPE_MESHES[m][0] for m, _, _ in C.PIPE_CASES.values()}
        batches = {M: 2 * M for _, _, M in C.PIPE_CASES.values()}
    else:
        stages = {shape[1] for shape, _, _ in C.HYBRID_CASES.values()}
        batches = {C.HYBRID_M: 4 * C.HYBRID_M}
        key = jax.random.PRNGKey(3)
        out["train/tokens"] = np.asarray(jax.random.randint(
            key, (C.TRAIN_BATCH, C.SEQ), 0, CFG.vocab_size))
        out["train/labels"] = out["train/tokens"]   # test_hybrid.py: one key
    for S in sorted(stages):
        pp = init_pipeline_params(CFG, jax.random.PRNGKey(0), S)
        out.update({f"p{S}/{k}": v for k, v in flat(pp).items()})
    for M, B in batches.items():
        out[f"data/M{M}/tokens"], out[f"data/M{M}/labels"] = data(M, B)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def executor(mesh, schedule, M, S, explicit, init_out, mb_part):
    pol = Policy.for_mesh(mesh, explicit_tp=explicit)
    pparams = unflat(C.subtree(init_out, f"p{S}"))
    pre_fn, stage_fn, logits_fn = pipeline_fns(CFG, pol)

    def post_fn(p_post, y, labels):
        return cross_entropy(logits_fn(p_post, y), labels)[0]

    f = pipeline_value_and_grad(
        pre_fn, stage_fn, post_fn, pol, make_schedule(schedule, M, S),
        params_parts=pipeline_param_parts(CFG, pol, pparams),
        x_parts={"tokens": mb_part}, y_parts=mb_part,
        pre_psum_axes=(pol.model_axis,) if explicit else ())
    tokens = jnp.asarray(init_out[f"data/M{M}/tokens"])
    labels = jnp.asarray(init_out[f"data/M{M}/labels"])
    loss, grads = f(pparams, {"tokens": tokens}, labels)
    return float(loss), flat(grads)


def run_pipeline(out, init_out):
    meshes = {k: compat.make_mesh(v, ("pipe", "model"))
              for k, v in C.PIPE_MESHES.items()}
    for cid, (mname, schedule, M) in C.PIPE_CASES.items():
        S = C.PIPE_MESHES[mname][0]
        loss, grads = executor(meshes[mname], schedule, M, S, True, init_out,
                               Partitioned())
        out[f"{cid}/loss"] = np.asarray(loss)
        out.update({f"{cid}/grad/{k}": v for k, v in grads.items()})


def run_hybrid(out, init_out):
    for cid, (shape, schedule, explicit) in C.HYBRID_CASES.items():
        dp, S, tp = shape
        loss, grads = executor(make_hybrid_mesh(dp, S, tp=tp), schedule,
                               C.HYBRID_M, S, explicit, init_out,
                               Partitioned(None, "data"))
        out[f"{cid}/loss"] = np.asarray(loss)
        out.update({f"{cid}/grad/{k}": v for k, v in grads.items()})
    from repro.optim import make_optimizer
    from repro.train import build_hybrid_train_step, init_train_state
    dp, S, tp = C.TRAIN_MESH
    pol = Policy.for_mesh(make_hybrid_mesh(dp, S, tp=tp), explicit_tp=True)
    opt = make_optimizer("adamw", total_steps=10)
    step = jax.jit(build_hybrid_train_step(CFG, pol, opt,
                                           num_microbatches=C.HYBRID_M))
    state = init_train_state(CFG, unflat(C.subtree(init_out, f"p{S}")), opt)
    batch = {"tokens": jnp.asarray(init_out["train/tokens"]),
             "labels": jnp.asarray(init_out["train/labels"])}
    for i in range(C.TRAIN_STEPS):
        state, met = step(state, batch)
        out[f"train/loss{i}"] = np.asarray(met["loss"])
        out[f"train/grad_norm{i}"] = np.asarray(met["grad_norm"])
    out.update({f"train/params/{k}": v
                for k, v in flat(state["params"]).items()})


def main(argv):
    which, path = argv
    if which not in ("pipeline", "hybrid"):
        raise SystemExit(f"unknown case set {which!r}")
    init_out = init(which, RC.params_path(path))
    out = {}
    (run_pipeline if which == "pipeline" else run_hybrid)(out, init_out)
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
