"""The hand-written kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's pins (tests/test_kernels.py): attention 2e-5
in fp32, RMSNorm 1e-5 in fp32, both 2e-2 in bf16; the SSD scan 1e-4 in
fp32 and 5e-2 in bf16, and 1e-4 on its final state for bf16 inputs too,
since both sides form it in fp32.  bf16 flash attention and SSD inputs take
the tensor-core kernels, fp32 ones the CUDA-core kernels
(``ops.ROUTE_LAUNCHES``).  This file imports no JAX, so it runs where only
the port and PyTorch are installed.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ssd_scan import TILES

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

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


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,Sq,Skv,H,KH,causal", [
    (1, 128, 128, 2, 2, True),
    (1, 128, 128, 2, 2, False),
    (2, 200, 200, 8, 2, True),    # ragged last q tile and KV tile
    (2, 200, 200, 8, 2, False),
    (1, 72, 200, 4, 1, False),    # Sq != Skv: non-causal (the top-left
])                                # causal mask is the reference's only at
def test_flash_tensor_core_kernel_bf16(gen, hd, B, Sq, Skv, H, KH, causal):
    q = _randn((B, Sq, H, hd), torch.bfloat16, gen)
    k = _randn((B, Skv, KH, hd), torch.bfloat16, gen)
    v = _randn((B, Skv, KH, hd), torch.bfloat16, gen)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=2e-2, rtol=2e-2)


def test_flash_tensor_core_kernel_reads_strided_inputs(gen):
    """bf16 q, k and v sliced out of one fused projection."""
    B, S, H, KH, hd = 2, 96, 8, 2, 64
    qkv = _randn((B, S, H + 2 * KH, hd), torch.bfloat16, gen)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.attention_ref(q, k, v),
                               atol=2e-2, rtol=2e-2)


def test_flash_tensor_core_kernel_refuses_misaligned(gen):
    """TMA needs strides of whole 16 bytes and a 16-byte aligned base: a
    bf16 input without them raises, and never reaches the fp32 kernel."""
    buf = _randn((1, 64, 4 * 64 + 4), torch.bfloat16, gen)
    q = buf.as_strided((1, 64, 4, 64), (64 * 260, 260, 64, 1))
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(q, q, q)
    q = buf.as_strided((1, 64, 4, 64), (64 * 260, 260 - 4, 64, 1), 4)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "cuda_core")])
def test_dtype_picks_the_route(gen, dtype, route):
    """bf16 launches the tensor-core kernels, fp32 the CUDA-core ones."""
    q = _randn((1, 64, 4, 64), dtype, gen)
    args = _ssd_inputs(1, 64, 2, 16, 16, dtype, gen)
    ops.reset_launches()
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    ops.ssd_scan(*args, chunk=32)
    other = {"tensor_core": "cuda_core", "cuda_core": "tensor_core"}[route]
    for name in ("flash_attention", "ssd_scan"):
        assert ops.ROUTE_LAUNCHES[name] == {route: 1, other: 0}
        assert ops.LAUNCHES[name] == 1


@pytest.mark.parametrize("rows,d", [
    (4, 4096), (4096, 4096), (1000, 4096),   # glm4-9b decode and prefill
    (8, 1024), (16384, 1024),                # mamba2-370m norm_mixer/final
    (8, 2048), (16384, 2048),                # mamba2-370m gated ssm_norm
    (6, 64), (3, 3072),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(gen, rows, d, dtype):
    x = _randn((rows, d), dtype, gen)
    w = 1.0 + 0.1 * _randn((d,), torch.float32, gen)
    before = ops.LAUNCHES["rmsnorm"]
    got = ops.rmsnorm(x, w)
    assert ops.LAUNCHES["rmsnorm"] == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, w),
                               atol=NORM_TOL[dtype], rtol=NORM_TOL[dtype])


def _ssd_inputs(B, S, H, P, N, dtype, gen):
    """x, dt, a_neg, Bm, Cm as the reference's sweep draws them."""
    return (_randn((B, S, H, P), dtype, gen),
            F.softplus(_randn((B, S, H), torch.float32, gen)) * 0.1,
            -torch.exp(_randn((H,), torch.float32, gen) * 0.2),
            _randn((B, S, N), dtype, gen), _randn((B, S, N), dtype, gen))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 16, 16, 32),     # the sweep of tests/test_kernels.py:95-100
    (2, 256, 4, 64, 32, 64),
    (1, 64, 1, 32, 128, 16),
    (1, 128, 8, 64, 64, 128),
    (2, 200, 32, 64, 128, 64),   # mamba2-370m heads, ragged last chunk
    (2, 40, 32, 64, 128, 64),    # a prompt shorter than one chunk
    (2, 77, 8, 16, 16, 64),      # reduced mamba2, ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(gen, B, S, H, P, N, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, N, dtype, gen)
    before = ops.LAUNCHES["ssd_scan"]
    y, h = ops.ssd_scan(*args, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for want_y, want_h in (ref.ssd_ref(*args),
                           ref.ssd_chunked(*args, chunk=chunk)):
        torch.testing.assert_close(y, want_y, atol=tol, rtol=tol)
        torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_model_draws(gen, dtype):
    """dt and A as mamba2's block makes them (dt = softplus of a unit-scale
    projection, A = exp(a_log), a_log ~ U[0, log 16)): per-step decays ~100x
    the sweep's, a chunk's cumsum of dt A reaches hundreds and |y| ~300.

    At that scale any fp32 chunked form (its exp(cumsum_l - cumsum_m), its
    sums of cancelling terms) is off the naive recurrence by up to ~1e-3
    absolute, also where y is near 0, and the kernel and the plain chunked
    form round differently.  So y is held to the naive recurrence within
    the pin plus twice the plain chunked form's own error there.  The
    state is held to the plain chunked form at the fp32 pin for both dtypes,
    since both sides form it in fp32 from the same inputs."""
    B, S, H, P, N = 2, 200, 32, 64, 128
    dt = F.softplus(_randn((B, S, H), torch.float32, gen))
    a_neg = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                       * math.log(16.0))
    args = (_randn((B, S, H, P), dtype, gen), dt, a_neg,
            _randn((B, S, N), dtype, gen), _randn((B, S, N), dtype, gen))
    y, h = ops.ssd_scan(*args, chunk=64)
    plain_y, plain_h = ref.ssd_chunked(*args, chunk=64)
    naive_y = ref.ssd_ref(*args)[0].float()
    plain_err = float((plain_y.float() - naive_y).abs().max())
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), naive_y, atol=tol + 2 * plain_err,
                               rtol=tol)
    torch.testing.assert_close(h, plain_h, atol=SSD_TOL[torch.float32],
                               rtol=SSD_TOL[torch.float32])


def test_ssd_kernel_reads_strided_inputs(gen):
    """x, B and C sliced out of fused projections, dt a strided view."""
    B, S, H, P, N = 2, 96, 4, 32, 32
    xz = _randn((B, S, 2 * H, P), torch.float32, gen)
    bc = _randn((B, S, 2 * N), torch.float32, gen)
    dt2 = F.softplus(_randn((B, S, 2 * H), torch.float32, gen)) * 0.1
    a_neg = -torch.exp(_randn((H,), torch.float32, gen) * 0.2)
    args = (xz[:, :, H:], dt2[:, :, ::2], a_neg, bc[:, :, :N], bc[:, :, N:])
    y, h = ops.ssd_scan(*args, chunk=32)
    want_y, want_h = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("chunk", TILES)
@pytest.mark.parametrize("S", [200, 40])   # ragged; shorter than some chunks
def test_ssd_tensor_core_kernel_bf16(gen, P, chunk, S):
    """y at the bf16 pin; the final state at the fp32 pin, against both
    plain forms (both form it in fp32 from the same bf16 inputs)."""
    args = _ssd_inputs(2, S, 8, P, 128, torch.bfloat16, gen)
    y, h = ops.ssd_scan(*args, chunk=chunk)
    for want_y, want_h in (ref.ssd_ref(*args),
                           ref.ssd_chunked(*args, chunk=chunk)):
        torch.testing.assert_close(y, want_y, atol=5e-2, rtol=5e-2)
        torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)


def test_ssd_tensor_core_kernel_reads_strided_inputs(gen):
    """bf16 x, B and C sliced out of fused projections, dt a strided view."""
    B, S, H, P, N = 2, 96, 4, 32, 32
    xz = _randn((B, S, 2 * H, P), torch.bfloat16, gen)
    bc = _randn((B, S, 2 * N), torch.bfloat16, gen)
    dt2 = F.softplus(_randn((B, S, 2 * H), torch.float32, gen)) * 0.1
    a_neg = -torch.exp(_randn((H,), torch.float32, gen) * 0.2)
    args = (xz[:, :, H:], dt2[:, :, ::2], a_neg, bc[:, :, :N], bc[:, :, N:])
    y, h = ops.ssd_scan(*args, chunk=32)
    want_y, want_h = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want_y, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)


def test_ssd_tensor_core_kernel_refuses_misaligned(gen):
    x, dt, a_neg, bm, cm = _ssd_inputs(1, 64, 2, 16, 16, torch.bfloat16, gen)
    buf = _randn((1, 64, 20), torch.bfloat16, gen)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.ssd_scan(x, dt, a_neg, buf[:, :, :16], cm)
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_scan(x, dt, a_neg, bm, buf[:, :, 4:])


def test_ssd_kernel_refuses_what_it_does_not_take(gen):
    x, dt, a_neg, bm, cm = _ssd_inputs(1, 64, 2, 48, 16, torch.float32, gen)
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_scan(x, dt, a_neg, bm, cm)
    x, dt, a_neg, bm, cm = _ssd_inputs(1, 64, 2, 16, 16, torch.float32, gen)
    with pytest.raises(ValueError, match="dtypes"):
        ops.ssd_scan(x, dt, a_neg, bm.bfloat16(), cm)
    x, dt, a_neg, bm, cm = _ssd_inputs(1, 300, 2, 16, 16, torch.float32, gen)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a_neg, bm, cm, chunk=256)
