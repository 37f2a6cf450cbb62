"""The JAX side of the port's sharded-serving parity test.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_serve_jax.py OUT.npz

First the reference's parameters of reduced mistral-large-123b and the
prompt, written at once to ``torch_region_cases.params_path(OUT)``:
``params/<key>`` and ``prompt``.  Then the reference engine on each case's
mesh and policy (its prefill and its decode are each one jitted program):
``<case>/logits`` (the prefill's last logits) and ``<case>/tokens`` (the
greedy tokens); and without a policy, ``none/logits``, ``none/tokens``.
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
import torch_serve_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serve import ServeEngine  # noqa: E402
from repro.sharding import Policy  # noqa: E402


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def main(argv):
    (path,) = argv
    cfg = reduced(get_config(C.ARCH))
    params = init_params(cfg, jax.random.PRNGKey(C.PARAMS_SEED))
    prompt = np.random.default_rng(C.PROMPT_SEED).integers(
        0, cfg.vocab_size, (C.BATCH, C.PROMPT), dtype=np.int32)
    init = {f"params/{k}": v for k, v in flat(params).items()}
    init["prompt"] = prompt
    tmp = f"{RC.params_path(path)}.tmp.npz"
    np.savez(tmp, **init)
    os.replace(tmp, RC.params_path(path))

    out = {}
    runs = {"none": (None, C.MAX_SEQ)}
    for case, (shape, layout, max_seq) in C.CASES.items():
        mesh = compat.make_mesh(shape, ("data", "model"))
        runs[case] = (Policy.for_mesh(mesh, kv_layout=layout), max_seq)
    for case, (pol, max_seq) in runs.items():
        eng = ServeEngine(cfg, params, pol, max_seq=max_seq,
                          batch_size=C.BATCH)
        logits, _ = eng.prefill(jnp.asarray(prompt))
        out[f"{case}/logits"] = np.asarray(logits)
        out[f"{case}/tokens"] = np.asarray(
            eng.generate(jnp.asarray(prompt), steps=C.STEPS))
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
