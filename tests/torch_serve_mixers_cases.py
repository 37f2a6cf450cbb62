"""Cases shared by the port's sharded serving of SSM mixers, MoE FFNs and
K/V and query head counts the model axis does not divide
(``test_torch_serve_mixers_md.py``) and its JAX side
(``torch_serve_mixers_jax.py``): the reference's ``ServeEngine(cfg,
params, Policy.for_mesh(mesh, kv_layout=...))`` on reduced configs over
(data, model) meshes of 8 host devices.  No JAX and no torch here: the
port's ranks and the JAX child both import it.

The JAX child draws each model's parameters (``init_params(cfg,
PRNGKey(PARAMS_SEED))``) and writes them all, with the prompt, first
(``torch_region_cases.params_path``), so the port's ranks start while it
serves.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

PARAMS_SEED = 0
BATCH, PROMPT, STEPS = 4, 16, 8
MAX_SEQ = PROMPT + STEPS + 8
PROMPT_SEED = 12

# model -> (arch, overrides of reduced(get_config(arch))).  reduced()
# gives 4 query heads, so no reduced arch has a rank holding parts of two
# GQA groups; "phi3_kv3" (12 query heads over 3 K/V heads at TP 2: a rank
# holds heads 0-5, K/V heads 0, 0, 0, 0, 1, 1) does, as phi3-medium-14b's
# 40 over 10 does at TP 4.  Query heads the model axis does not divide,
# split by the balanced decomposition as at 16 x 16: "phi3_h10" (10 over
# 5 K/V heads at TP 4: 3, 3, 2, 2 heads, ranks 0 and 1 holding parts of
# two groups) and "phi4_h6" (6 over 2 K/V heads, tied embeddings: 2, 2,
# 1, 1 heads).
MODELS = {
    "jamba": ("jamba-v0.1-52b", {}),          # (ssm, mlp), (ssm, moe), (attn, mlp)
    "mamba2": ("mamba2-370m", {}),            # ssm only, tied embeddings
    "kimi": ("kimi-k2-1t-a32b", {}),          # MoE every layer, a shared expert
    "llama4": ("llama4-maverick-400b-a17b", {}),   # top-1, a shared expert
    "glm4": ("glm4-9b", {}),                  # 2 K/V heads
    "phi3_kv3": ("phi3-medium-14b", {"num_heads": 12, "num_kv_heads": 3}),
    "phi3_h10": ("phi3-medium-14b", {"num_heads": 10, "num_kv_heads": 5}),
    "phi4_h6": ("phi4-mini-3.8b", {"num_heads": 6, "num_kv_heads": 2}),
}

# name -> (model, (data, model), kv_layout)
CASES = {
    "jamba_dp2_tp4_kvdim": ("jamba", (2, 4), "kvdim"),
    "jamba_dp4_tp2_kvseq": ("jamba", (4, 2), "kvseq"),
    "mamba2_dp2_tp4": ("mamba2", (2, 4), "kvdim"),
    "kimi_dp2_tp4_kvdim": ("kimi", (2, 4), "kvdim"),
    "llama4_dp4_tp2_kvseq": ("llama4", (4, 2), "kvseq"),
    "glm4_dp2_tp4_kvdim": ("glm4", (2, 4), "kvdim"),
    "glm4_dp2_tp4_kvseq": ("glm4", (2, 4), "kvseq"),
    "phi3_kv3_dp4_tp2_kvdim": ("phi3_kv3", (4, 2), "kvdim"),
    "phi3_h10_dp2_tp4_kvdim": ("phi3_h10", (2, 4), "kvdim"),
    "phi3_h10_dp2_tp4_kvseq": ("phi3_h10", (2, 4), "kvseq"),
    "phi4_h6_dp2_tp4_kvdim": ("phi4_h6", (2, 4), "kvdim"),
    "phi4_h6_dp2_tp4_kvseq": ("phi4_h6", (2, 4), "kvseq"),
}

# the fp32 pin: prefill logits within 1e-3 of scale, greedy tokens equal
LOGITS_TOL = 1e-3


def model_config(model, get_config, reduced):
    """The reduced config of ``model``, from either package's ``configs``."""
    arch, overrides = MODELS[model]
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def start_jax(out_path):
    """Start ``torch_serve_mixers_jax.py`` on 8 host devices in a child
    interpreter (the main pytest process must see one device)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_serve_mixers_jax.py"),
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
