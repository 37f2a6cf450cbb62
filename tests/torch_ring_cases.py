"""Cases shared by the port's context-parallel parity test
(``test_torch_ring.py``) and its JAX side (``torch_ring_jax.py``): the
cases of tests/md/test_ring_attention.py at that file's pins.  No JAX and
no torch here: the port's ranks and the JAX child both import it.

The JAX child draws the reference's inputs and parameters with that
file's keys and writes them first (``torch_region_cases.params_path``), so
the port's ranks start while it computes the rest.
"""

from __future__ import annotations

import os
import subprocess
import sys

# tests/md/test_hybrid.py::CFG, the model of every hybrid case
CFG = dict(name="hy_test", family="dense", num_layers=4, d_model=64,
           num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
           vocab_size=128, dtype="float32", remat=False, attn_chunk=16)

# ring_attention on the (8,) ctx mesh against blockwise_attention:
# name -> (B, S, H, KH, hd, chunk, causal).  "ragged" has S_loc = 20, so
# the last chunk of every hop is zero-padded and masked.
RING_CASES = {
    "kh8_causal": (2, 64, 8, 8, 16, 16, True),
    "kh2_causal": (2, 64, 8, 2, 16, 16, True),
    "kh1_causal": (2, 64, 8, 1, 16, 16, True),
    "kh4_full": (2, 64, 8, 4, 16, 16, False),
    "ragged": (2, 160, 8, 2, 16, 16, True),
}
# ring_attention_region with KH < tp on (data, ctx, model) = (1, 2, 4)
GQA_CASE = (2, 32, 8, 2, 16, 8)          # B, S, H, KH, hd, chunk
GQA_MESH = (1, 2, 4)

# the hybrid executor (dp, pp, cp, tp) with a live ctx axis, M 4, batch 16,
# seq 16; explicit TP where the mesh has a model axis of size > 1
HYBRID_M, HYBRID_BATCH, HYBRID_SEQ = 4, 16, 16
HYBRID_CASES = {
    "2122": ((2, 1, 2, 2), True),
    "1142": ((1, 1, 4, 2), True),
    "2141": ((2, 1, 4, 1), False),
    "1222": ((1, 2, 2, 2), True),
}

# forward() over (data, ctx, model) = (2, 2, 2) with explicit TP against
# policy=None: batch (8, 32) from PRNGKey(3), params from PRNGKey(0)
FWD_MESH, FWD_BATCH, FWD_SEQ = (2, 2, 2), 8, 32

# the CLI: reduced glm4-9b, --hybrid-mesh 2,1,2,2, seed 0
CLI = dict(arch="glm4-9b", hybrid=(2, 1, 2, 2, 1), microbatches=4, steps=3,
           batch=16, seq=32, seed=0)

# tests/md/test_ring_attention.py's pins (and test_hybrid.py's)
FWD_TOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
LOSS_RTOL = 2e-5
HYBRID_TOL = 5e-4
GSPMD_LOSS_RTOL, GSPMD_GRAD_TOL = 1e-5, 5e-4
CLI_LOSS_RTOL = 2e-5


def start_jax(out_path):
    """Start ``torch_ring_jax.py`` on 8 host devices in a child interpreter
    (the main pytest process must see one device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_ring_jax.py"),
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def subtree(flat: dict, prefix: str) -> dict:
    """``{key: leaf}`` of the entries ``prefix/key`` of a flat npz dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
