"""Cases shared by the port's sharded-serving parity test
(``test_torch_serve_md.py``) and its JAX side (``torch_serve_jax.py``): the
reference's ``ServeEngine(cfg, params, Policy.for_mesh(mesh,
kv_layout=...))`` on reduced mistral-large-123b over (data, model)
meshes of 8 host devices.  No JAX and no torch here: the port's ranks and
the JAX child both import it.

The JAX child draws the reference's parameters (``init_params(cfg,
PRNGKey(PARAMS_SEED))``) and writes them, with the prompt, first
(``torch_region_cases.params_path``), so the port's ranks start while it
serves.
"""

from __future__ import annotations

import os
import subprocess
import sys

ARCH = "mistral-large-123b"      # reduced(): d 64, 4 heads, 4 kv heads, hd 16
PARAMS_SEED = 0
BATCH, PROMPT, STEPS = 4, 16, 8
MAX_SEQ = PROMPT + STEPS + 8
PROMPT_SEED = 11

# name -> ((data, model), kv_layout, max_seq); "ragged": max_seq 30 is not
# a multiple of the model axis's 4 (the kvseq blocks cover 32 positions)
CASES = {
    "dp2_tp4_kvdim": ((2, 4), "kvdim", MAX_SEQ),
    "dp2_tp4_kvseq": ((2, 4), "kvseq", MAX_SEQ),
    "dp4_tp2_kvdim": ((4, 2), "kvdim", MAX_SEQ),
    "dp4_tp2_kvseq": ((4, 2), "kvseq", MAX_SEQ),
    "ragged_kvseq": ((2, 4), "kvseq", 30),
}

# the fp32 pin: prefill logits within 1e-3 of scale, greedy tokens equal
LOGITS_TOL = 1e-3


def start_jax(out_path):
    """Start ``torch_serve_jax.py`` on 8 host devices in a child interpreter
    (the main pytest process must see one device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_serve_jax.py"),
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
