"""The benchmark's frozen arithmetic against hand counts: the copy of the
kernels' operations and bytes, and the model-FLOP formulas, at glm4-9b's
and mamba2-370m's shapes."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from reference import cost, flops, peaks  # noqa: E402

GLM = json.loads((BENCH / "configs" / "glm4-9b.json").read_text())
GLM8 = json.loads((BENCH / "configs" / "glm4-9b.l8.json").read_text())
MAMBA = json.loads((BENCH / "configs" / "mamba2-370m.json").read_text())


def test_flash_cost_by_hand():
    # q (4, 2048, 32, 128), k v (4, 2048, 2, 128) bf16, causal:
    # 2048 * 2049 / 2 pairs a (batch, head), 4 * 128 operations a pair
    c = cost.kernel_cost("flash_attention", (4, 2048, 32, 128),
                         (4, 2048, 2, 128), (4, 2048, 2, 128),
                         dtype=torch.bfloat16, causal=True)
    assert c["flops"] == 4 * 32 * 512 * 2098176
    assert c["bytes"] == 2 * (2 * 4 * 2048 * 32 * 128 + 2 * 4 * 2048 * 2 * 128)


def test_ssd_cost_by_hand():
    # x (8, 8192, 32, 64), B and C (8, 8192, 128) bf16, chunks of 64
    c = cost.kernel_cost("ssd_scan", (8, 8192, 32, 64), (8, 8192, 32), (32,),
                         (8, 8192, 128), (8, 8192, 128),
                         dtype="torch.bfloat16", chunk=64)
    nc = 128
    assert c["flops"] == (8 * nc * 2 * 64 * 64 * 128
                          + 8 * 32 * nc * (2 * 64 * 64 * 64
                                           + 4 * 64 * 128 * 64))
    assert c["bytes"] == (2 * 2 * 8 * 8192 * 32 * 64 + 4 * 8 * 8192 * 32
                          + 4 * 32 + 2 * 2 * 8 * 8192 * 128
                          + 4 * 8 * 32 * 64 * 128)


def test_rmsnorm_cost_by_hand():
    c = cost.kernel_cost("rmsnorm", (4096, 4096), (4096,),
                         dtype=torch.bfloat16, w_dtype=torch.float32)
    assert c == {"flops": 4 * 4096 * 4096,
                 "bytes": 2 * 2 * 4096 * 4096 + 4 * 4096}


def test_copy_matches_the_program_today():
    from repro_torch.kernels.cost import kernel_cost
    cases = [("flash_attention", ((4, 1024, 32, 128), (4, 1024, 2, 128),
                                  (4, 1024, 2, 128)), {}),
             ("ssd_scan", ((8, 2048, 32, 64), (8, 2048, 32), (32,),
                           (8, 2048, 128), (8, 2048, 128)), {"chunk": 64}),
             ("rmsnorm", ((4, 1024, 4096), (4096,)), {})]
    for name, shapes, kw in cases:
        assert cost.kernel_cost(name, *shapes, dtype=torch.bfloat16, **kw) \
            == kernel_cost(name, *shapes, dtype=torch.bfloat16, **kw)


def test_glm_matmul_params_by_hand():
    attn = 4096 * 4096 + 2 * 4096 * 256 + 4096 * 4096
    mlp = 3 * 4096 * 13696
    assert flops.layer_matmul_params(GLM) == attn + mlp == 203_948_032
    assert flops.head_params(GLM) == 4096 * 151552


def test_mamba_matmul_params_by_hand():
    d, din = 1024, 2048
    assert flops.layer_matmul_params(MAMBA) == \
        d * (2 * din + 2 * 128 + 32) + din * d
    assert flops.head_params(MAMBA) == 1024 * 50280


def test_train_step_flops_by_hand():
    B, S = 4, 1024
    params = 8 * 203_948_032 + 4096 * 151552
    attn = 8 * B * 4 * 32 * 128 * (S * (S + 1) // 2)
    assert flops.train_step_flops(GLM8, B, S) == 6 * params * B * S \
        + 3 * attn


def test_prefill_flops_by_hand():
    B, S = 8, 8192
    per_token = 4 * 32 * 64 * 128 + 2 * 4 * 2048
    layer = 1024 * (2 * 2048 + 2 * 128 + 32) + 2048 * 1024
    assert flops.prefill_flops(MAMBA, B, S) == (
        2 * 48 * layer * B * S + 2 * 1024 * 50280 * B
        + 48 * B * S * per_token)


@pytest.mark.parametrize("route,rate", [("tensor_core", 989e12),
                                        ("tf32x3", 494.5e12 / 3)])
def test_bound_takes_the_larger_time(route, rate):
    assert peaks.bound_s({"flops": 1e12, "bytes": 0}, route) == 1e12 / rate
    assert peaks.bound_s({"flops": 0, "bytes": 3.35e12}, route) == 1.0
