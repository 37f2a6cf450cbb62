"""The hand-written kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's pins (tests/test_kernels.py): attention 2e-5
in fp32, RMSNorm 1e-5 in fp32, both 2e-2 in bf16.  This file imports no
JAX, so it runs where only the port and PyTorch are installed.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("B,S,H,KH,hd", [
    (2, 512, 32, 2, 128),   # glm4-9b heads
    (2, 200, 32, 2, 128),   # ragged last tile
    (1, 128, 4, 4, 64),     # MHA
    (1, 77, 8, 1, 32),      # MQA, ragged
    (2, 64, 4, 2, 16),      # reduced configs' head dim
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(gen, B, S, H, KH, hd, dtype, causal):
    q = _randn((B, S, H, hd), dtype, gen)
    k = _randn((B, S, KH, hd), dtype, gen)
    v = _randn((B, S, KH, hd), dtype, gen)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def test_flash_kernel_reads_strided_inputs(gen):
    """q, k and v sliced out of one fused projection (non-contiguous heads)."""
    B, S, H, KH, hd = 2, 96, 8, 2, 64
    qkv = _randn((B, S, H + 2 * KH, hd), torch.float32, gen)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.attention_ref(q, k, v),
                               atol=2e-5, rtol=2e-5)


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    q = _randn((1, 64, 4, 48), torch.float32, gen)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = _randn((1, 64, 4, 64), torch.float32, gen)
    with pytest.raises(ValueError, match="dtypes"):
        ops.flash_attention(q, q.bfloat16(), q)


@pytest.mark.parametrize("rows,d", [(4, 4096), (4096, 4096), (1000, 4096),
                                    (6, 64), (3, 3072)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(gen, rows, d, dtype):
    x = _randn((rows, d), dtype, gen)
    w = 1.0 + 0.1 * _randn((d,), torch.float32, gen)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, w)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, w),
                               atol=NORM_TOL[dtype], rtol=NORM_TOL[dtype])
