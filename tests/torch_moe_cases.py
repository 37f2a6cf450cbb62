"""Cases shared by the port's expert-parallel parity test
(``test_torch_moe_md.py``) and its JAX side (``torch_moe_jax.py``): every
case of tests/md/test_moe_md.py at that file's pins.  No JAX and no torch
here: the port's ranks and the JAX child both import it.

The JAX child draws the reference's parameters and inputs with its own
keys (as test_moe_md.py does) and writes them first
(``torch_region_cases.params_path``), so the port's ranks start while it
computes the rest.
"""

from __future__ import annotations

import os
import subprocess
import sys

ARCH = "jamba-v0.1-52b"          # reduced(); capacity_factor 4.0: no drops
CAPACITY = 4.0
TIGHT = 0.5                      # capacity_factor that drops tokens
X_SHAPE = {"fwd": (4, 16), "grads": (4, 16), "drops": (4, 16),
           "drop_set": (8, 16), "big_e": (8, 16), "raise": (8, 16)}
X_KEY = {"fwd": 1, "grads": 2, "drops": 3, "big_e": 4, "drop_set": 5,
         "raise": 6}
AUX_WEIGHT = 0.01                # loss = sum(y ** 2) + 0.01 aux
BIG_E = 8                        # the ep-8 leg: one expert per rank

# the (dp, ep) = (2, 4) and (ep, tp) = (4, 2) hybrid meshes against the
# single-device mesh: (dp, S, cp, tp, ep)
HYBRID_CFG = dict(name="ep-grads", family="moe", num_layers=2, d_model=64,
                  num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
                  vocab_size=256, dtype="float32", remat=False,
                  attn_chunk=16, num_experts=4, experts_per_token=2,
                  moe_d_ff=96, moe_layer_period=2, moe_offset=1,
                  num_shared_experts=1, capacity_factor=4.0)
HYBRID_MESHES = {"ref": (1, 1, 1, 1, 1), "dp_ep": (2, 1, 1, 1, 4),
                 "ep_tp": (1, 1, 1, 2, 4)}
HYBRID_M, HYBRID_BATCH, HYBRID_SEQ = 2, 16, 16

# test_moe_md.py's pins
Y_TOL = 2e-4
GRAD_TOL = 5e-4
LOSS_RTOL = 1e-5
HYBRID_ATOL, HYBRID_RTOL = 1e-5, 2e-4


def start_jax(out_path):
    """Start ``torch_moe_jax.py`` on 8 host devices in a child interpreter
    (the main pytest process must see one device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_moe_jax.py"),
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def subtree(flat: dict, prefix: str) -> dict:
    """``{key: leaf}`` of the entries ``prefix/key`` of a flat npz dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
