"""Cases shared by the port's pipeline and hybrid parity tests
(``test_torch_pipeline.py``, ``test_torch_hybrid.py``) and their JAX side
(``torch_pipeline_jax.py``).  No JAX here: the port's ranks import it.

The config and the pins are the reference's own (tests/md/test_pipeline.py,
tests/md/test_hybrid.py): loss rtol 2e-5, every grad leaf rtol and atol
5e-4.  The JAX child writes the reference's parameters and data first
(``torch_region_cases.params_path``), so the port's ranks start while it
computes the rest.
"""

from __future__ import annotations

import os
import subprocess
import sys

CFG = dict(name="hy_test", family="dense", num_layers=4, d_model=64,
           num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
           vocab_size=128, dtype="float32", remat=False, attn_chunk=16)
SEQ = 16
LOSS_RTOL = 2e-5
GRAD_TOL = 5e-4

# test_pipeline.py: (mesh, schedule, M); explicit TP; batch 2M, params of
# the mesh's stage count
PIPE_MESHES = {"4x2": (4, 2), "1x2": (1, 2)}
PIPE_CASES = {
    "1f1b": ("4x2", "1f1b", 4),
    "fill_drain": ("4x2", "fill_drain", 4),
    "m6": ("4x2", "1f1b", 6),          # M not divisible by S
    "s1": ("1x2", "1f1b", 3),          # the degenerate single stage
}

# test_hybrid.py: ((dp, S, tp), schedule, explicit TP); M 4, batch 16
HYBRID_M = 4
HYBRID_CASES = {
    "222_1f1b": ((2, 2, 2), "1f1b", True),
    "222_fill_drain": ((2, 2, 2), "fill_drain", True),
    "421_1f1b": ((4, 2, 1), "1f1b", False),
}
# two AdamW steps of build_hybrid_train_step on (2, 2, 2), the same batch
# twice (test_hybrid.py::test_two_steps_and_dp1_equals_pipeline_builder)
TRAIN_MESH, TRAIN_STEPS, TRAIN_BATCH = (2, 2, 2), 2, 16


def start_jax(which: str, out_path):
    """Start ``torch_pipeline_jax.py`` on 8 host devices in a child
    interpreter (the main pytest process must see one device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_pipeline_jax.py"), which,
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def subtree(flat: dict, prefix: str) -> dict:
    """``{key: leaf}`` of the entries ``prefix/key`` of a flat npz dict."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}
