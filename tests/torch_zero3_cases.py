"""Cases shared by the port's policy-train-program parity test
(``test_torch_zero3_md.py``) and its JAX side (``torch_zero3_jax.py``):
the reference's GSPMD ``build_train_step(cfg, Policy(mesh), opt)`` (ZeRO-3
over ``data``, tensor and sequence parallelism over ``model``) on reduced
configs over (data, model) meshes of the first 6 or all 8 host devices.  No JAX and no torch
here: the port's ranks and the JAX child both import it.

The JAX child draws the reference's parameters of each arch
(``init_params(cfg, PRNGKey(PARAMS_SEED))``) and writes them first
(``torch_region_cases.params_path``), so the port's ranks start while it
runs the cases.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np

PARAMS_SEED = 0
BATCH, SEQ = 8, 16
LR, TOTAL_STEPS = 1e-3, 10

# model -> (arch, overrides of reduced(get_config(arch))).  reduced
# glm4-9b: 4 query heads and 2 K/V heads, so model = 4 does not divide its
# K/V heads; kimi-k2 (MoE, Adafactor) cut to one block period;
# mamba2-370m (SSM, tied embeddings) at reduced()'s 2 layers; "glm4-h6":
# 6 query heads over 2 K/V heads of 16, which model = 4 does not divide:
# the reference's spec splits wq's 96 columns 24 a rank (1.5 heads, mid
# head, as phi3-medium-14b's 5120 at 16) and each rank attends its
# balanced block of 2, 2, 1 or 1 heads.
# "glm4-accum2": reduced glm4-9b (the same parameters) at grad_accum 2.
# "kimi-e6": kimi-k2's period with 6 experts, which model = 3 divides
# while the sequence 16 is not: each rank routes the whole sequence.
ARCHS = {"glm4-9b": ("glm4-9b", {}),
         "kimi-k2-1t-a32b": ("kimi-k2-1t-a32b", {"num_layers": 1}),
         "mamba2-370m": ("mamba2-370m", {}),
         "glm4-h6": ("glm4-9b", {"num_heads": 6, "num_kv_heads": 2}),
         "glm4-accum2": ("glm4-9b", {"grad_accum": 2}),
         "kimi-e6": ("kimi-k2-1t-a32b", {"num_layers": 1, "num_experts": 6})}

# name -> (arch, (data, model)) of the port's cases
CASES = {
    "glm_dp2_tp4": ("glm4-9b", (2, 4)),
    "glm_dp4_tp2": ("glm4-9b", (4, 2)),
    "glm_dp8_tp1": ("glm4-9b", (8, 1)),
    "kimi_dp2_tp4": ("kimi-k2-1t-a32b", (2, 4)),
    "mamba_dp2_tp4": ("mamba2-370m", (2, 4)),
    "glm_h6_dp2_tp4": ("glm4-h6", (2, 4)),
    # two microbatches a step (the reference's scan over the global batch
    # cut in two), and mamba2's 8 SSM heads, d_inner 128 and the sequence
    # 16 over model = 3 (6 of the 8 ranks): every SSM leaf whole over
    # model, each rank's heads and the sequence the balanced split
    "glm_accum2_dp2_tp4": ("glm4-accum2", (2, 4)),
    "mamba_dp2_tp3": ("mamba2-370m", (2, 3)),
    "kimi_e6_dp2_tp3": ("kimi-e6", (2, 3)),
    # model = 8, larger than reduced glm4-9b's 4 query heads: ranks 4-7
    # hold empty head blocks and contribute zero to attention
    "glm_dp1_tp8": ("glm4-9b", (1, 8)),
}
# The reference runs on (2, 4) only, in three JAX children side by side (a
# jitted program a mesh is most of this file's time): its GSPMD step
# computes global values, the same on every mesh to fp32 rounding (on
# these cases its losses at (2, 4), (4, 2) and (8, 1) agree to 7e-8 and
# its grad norms to 1e-7 relative; at (1, 8), where ranks 4-7 hold no
# query head, it runs too, its first loss and grad norm within 1e-7 of
# (2, 4)'s), so each glm4-9b mesh of the port is held to the reference's
# (2, 4) run, whose gradients are also written (GRADS_CASES, as are
# glm4-h6's).
REFERENCE = {"glm_dp2_tp4": "glm_dp2_tp4", "glm_dp4_tp2": "glm_dp2_tp4",
             "glm_dp8_tp1": "glm_dp2_tp4", "glm_dp1_tp8": "glm_dp2_tp4",
             "kimi_dp2_tp4": "kimi_dp2_tp4",
             "mamba_dp2_tp4": "mamba_dp2_tp4",
             "glm_h6_dp2_tp4": "glm_h6_dp2_tp4",
             "glm_accum2_dp2_tp4": "glm_accum2_dp2_tp4",
             "mamba_dp2_tp3": "mamba_dp2_tp3",
             "kimi_e6_dp2_tp3": "kimi_e6_dp2_tp3"}
CHILDREN = {"glm": ("glm_dp2_tp4", "mamba_dp2_tp3"),
            "mamba": ("mamba_dp2_tp4", "glm_h6_dp2_tp4", "kimi_e6_dp2_tp3"),
            "kimi": ("kimi_dp2_tp4", "glm_accum2_dp2_tp4")}
GRADS_CASES = ("glm_dp2_tp4", "glm_h6_dp2_tp4", "glm_accum2_dp2_tp4",
               "mamba_dp2_tp3", "kimi_e6_dp2_tp3")
CKPT_CASE = "glm_dp2_tp4"

# the pins: tests/md/test_hybrid.py's for the gradients, 2e-5 for the loss
LOSS_RTOL = 2e-5
GRAD_TOL = 5e-4


def model_config(model, get_config, reduced):
    """The reduced config of ``model``, from either package's
    ``configs``."""
    arch, overrides = ARCHS[model]
    return dataclasses.replace(reduced(get_config(arch)), **overrides)


def batches(vocab: int) -> list:
    """The two steps' global batches, ``{"tokens", "labels"}`` int32."""
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")} for _ in range(2)]


def child_path(out_path, which: str) -> str:
    return f"{out_path}.{which}.npz"


def start_jax(out_path, which: str):
    """Start ``torch_zero3_jax.py`` for the cases of ``CHILDREN[which]``
    on 8 host devices in a child interpreter (the main pytest process
    must see one device); it writes ``child_path(out_path, which)``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_zero3_jax.py"), which,
         child_path(out_path, which)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
