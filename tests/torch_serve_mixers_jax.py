"""The JAX side of the port's sharded-serving parity test for SSM mixers,
MoE FFNs and K/V head counts the model axis does not divide.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_serve_mixers_jax.py OUT.npz

First every model's reference parameters and the prompt, written at once
to ``torch_region_cases.params_path(OUT)``: ``<model>/<key>`` and
``prompt``.  Then the reference engine on each case's mesh and policy
(its prefill and its decode are each one jitted program):
``<case>/logits`` (the prefill's last logits) and ``<case>/tokens`` (the
greedy tokens).  A mesh of fewer than 8 devices takes the first ones; an
``EMBEDS`` case prefills from the stub frontend's embeddings.
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
import torch_serve_mixers_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serve import ServeEngine  # noqa: E402
from repro.sharding import Policy  # noqa: E402
from torch_serve_jax import flat  # noqa: E402


def main(argv):
    (path,) = argv
    cfgs = {m: C.model_config(m, get_config, reduced) for m in C.MODELS}
    params = {m: init_params(cfg, jax.random.PRNGKey(C.PARAMS_SEED))
              for m, cfg in cfgs.items()}
    prompt = np.random.default_rng(C.PROMPT_SEED).integers(
        0, min(c.vocab_size for c in cfgs.values()), (C.BATCH, C.PROMPT),
        dtype=np.int32)
    init = {f"{m}/{k}": v for m, p in params.items()
            for k, v in flat(p).items()}
    init["prompt"] = prompt
    tmp = f"{RC.params_path(path)}.tmp.npz"
    np.savez(tmp, **init)
    os.replace(tmp, RC.params_path(path))

    out = {}
    for case, (model, shape, layout) in C.CASES.items():
        mesh = compat.make_mesh(shape, ("data", "model"),
                                devices=jax.devices()[:shape[0] * shape[1]])
        eng = ServeEngine(cfgs[model], params[model],
                          Policy.for_mesh(mesh, kv_layout=layout),
                          max_seq=C.MAX_SEQ, batch_size=C.BATCH)
        if case in C.EMBEDS:
            emb = jnp.asarray(C.embeds(cfgs[model].d_model, np))
            logits, cache = eng._prefill(eng.params, {"embeds": emb})
            out[f"{case}/logits"] = np.asarray(logits)
            tokens = []
            for t in range(C.STEPS):
                tokens.append(eng._pick(logits, True, None, 1.0, t))
                logits, cache = eng.decode_step(cache, tokens[-1],
                                                jnp.int32(C.PROMPT + t))
            out[f"{case}/tokens"] = np.asarray(jnp.concatenate(tokens, 1))
            continue
        logits, _ = eng.prefill(jnp.asarray(prompt))
        out[f"{case}/logits"] = np.asarray(logits)
        out[f"{case}/tokens"] = np.asarray(
            eng.generate(jnp.asarray(prompt), steps=C.STEPS))
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
