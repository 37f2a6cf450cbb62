"""Cases shared by the port's sharded serving of SSM mixers, MoE FFNs,
K/V and query head counts and widths the model axis does not divide
(``test_torch_serve_mixers_md.py``) and its JAX side
(``torch_serve_mixers_jax.py``): the reference's ``ServeEngine(cfg,
params, Policy.for_mesh(mesh, kv_layout=...))`` on reduced configs over
(data, model) meshes of the first 6 or all 8 host devices.  No JAX and no
torch here: the port's ranks and the JAX child both import it.

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
# 1, 1 heads).  At model = 3 no width of reduced glm4-9b divides (d_model
# 64, head_dim 16, d_ff 128; 4 query heads split 2, 1, 1 and its 2 K/V
# heads stay whole) nor mamba2-370m's 8 SSM heads and d_inner 128;
# "jamba_e6" and "kimi_e6" take 6 experts (3 divides them), and kimi's
# shared expert d_ff 100 (96 would divide).  "phi3_kv3" at model = 3
# splits its 3 K/V heads one a rank but not head_dim 16 (6, 5, 5), so
# decode moves q, k and v to unequal head_dim blocks.  "pixtral" serves
# from the stub frontend's embeds (``EMBEDS``).  At model = 8, larger
# than the head counts, ranks hold empty head blocks: reduced glm4-9b's 4
# query heads leave ranks 4-7 none (its 2 K/V heads whole), and
# "mamba2_p32" (head dim 32: 4 SSM heads, d_inner 128) leaves ranks 4-7
# no SSM head and no d_inner channel; each still takes part in every
# collective, with zero-size blocks.
MODELS = {
    "jamba": ("jamba-v0.1-52b", {}),          # (ssm, mlp), (ssm, moe), (attn, mlp)
    "mamba2": ("mamba2-370m", {}),            # ssm only, tied embeddings
    "mamba2_p32": ("mamba2-370m", {"ssm_head_dim": 32}),
    "kimi": ("kimi-k2-1t-a32b", {}),          # MoE every layer, a shared expert
    "llama4": ("llama4-maverick-400b-a17b", {}),   # top-1, a shared expert
    "glm4": ("glm4-9b", {}),                  # 2 K/V heads
    "phi3_kv3": ("phi3-medium-14b", {"num_heads": 12, "num_kv_heads": 3}),
    "phi3_h10": ("phi3-medium-14b", {"num_heads": 10, "num_kv_heads": 5}),
    "phi4_h6": ("phi4-mini-3.8b", {"num_heads": 6, "num_kv_heads": 2}),
    "jamba_e6": ("jamba-v0.1-52b", {"num_experts": 6}),
    "kimi_e6": ("kimi-k2-1t-a32b", {"num_experts": 6, "moe_d_ff": 100}),
    "pixtral": ("pixtral-12b", {}),
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
    "glm4_dp2_tp3_kvdim": ("glm4", (2, 3), "kvdim"),
    "glm4_dp1_tp3_kvseq": ("glm4", (1, 3), "kvseq"),
    "mamba2_dp2_tp3": ("mamba2", (2, 3), "kvdim"),
    "jamba_e6_dp2_tp3_kvdim": ("jamba_e6", (2, 3), "kvdim"),
    "kimi_e6_dp2_tp3_kvdim": ("kimi_e6", (2, 3), "kvdim"),
    "pixtral_embeds_dp2_tp4_kvdim": ("pixtral", (2, 4), "kvdim"),
    "phi3_kv3_dp2_tp3_kvdim": ("phi3_kv3", (2, 3), "kvdim"),
    "glm4_dp1_tp8_kvdim": ("glm4", (1, 8), "kvdim"),
    "glm4_dp1_tp8_kvseq": ("glm4", (1, 8), "kvseq"),
    "mamba2_p32_dp1_tp8": ("mamba2_p32", (1, 8), "kvdim"),
}
# the cases that prefill from ``embeds(d_model)`` in place of the prompt
# (the greedy decode steps take tokens, as the engine's)
EMBEDS = ("pixtral_embeds_dp2_tp4_kvdim",)
EMBEDS_SEED = 13

# the fp32 pin: prefill logits within 1e-3 of scale, greedy tokens equal
LOGITS_TOL = 1e-3


def model_config(model, get_config, reduced):
    """The reduced config of ``model``, from either package's ``configs``."""
    arch, overrides = MODELS[model]
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def embeds(d: int, np):
    """The prompt's stub-frontend embeddings, (BATCH, PROMPT, d) float32."""
    return np.random.default_rng(EMBEDS_SEED).standard_normal(
        (BATCH, PROMPT, d)).astype(np.float32)


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
