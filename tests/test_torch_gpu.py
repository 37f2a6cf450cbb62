"""The hand-written kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA device (decided in the
fixture, never at import).  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's pins (tests/test_kernels.py): attention 2e-5
in fp32, RMSNorm 1e-5 in fp32, both 2e-2 in bf16; the SSD scan 1e-4 in
fp32 and 5e-2 in bf16, and 1e-4 on its final state for bf16 inputs too,
since both sides form it in fp32.  bf16 flash attention and SSD inputs take
the bf16 tensor-core kernels, fp32 ones the 3xTF32 kernels
(``ops.ROUTE_LAUNCHES``).  Gradients through each kernel's autograd
Function (the kernel's forward, a backward recomputed through the plain
version) must equal the plain function's own autograd within the same pins,
and two train steps of a small model on the card must track the host, by
the single-device step and by the hybrid pipeline step at mesh (1, 1, 1).
Head dim 112 (kimi-k2-1t-a32b) on both flash routes, and the ring of
``core/ring_attention.py`` composed from four virtual ranks against the
plain blockwise attention.
The paper's primitives, LinearOps and memory operators pass Eq. 13 on CUDA
tensors over NCCL, one rank per card (``launch/dist_check.py`` at its small
shapes); the two-card case skips on a one-card machine, and the
three-card non-cyclic shift by 2 (a rank with neither source nor
destination joins no p2p batch) below three cards.
This file imports no JAX, so it runs where only the port and PyTorch are
installed.
"""

import dataclasses
import functools
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.core import primitives as prim
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.launch import dist_check, mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import (from_pipeline_params, init_params,
                                init_pipeline_params, moe)
from repro_torch.optim import make_optimizer
from repro_torch.train import build_train_step, init_train_state
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


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,Sq,Skv,H,KH,causal", [
    (1, 128, 128, 2, 2, True),
    (2, 200, 200, 8, 2, True),    # ragged last q tile and KV tile
    (2, 200, 200, 8, 2, False),
    (1, 72, 200, 4, 1, False),    # Sq != Skv
    (1, 300, 70, 4, 4, True),     # Sq > Skv: rows past Skv see every key
])
def test_flash_tf32x3_kernel_fp32(gen, hd, B, Sq, Skv, H, KH, causal):
    """The fp32 route (3xTF32 split products) at every head dim, at the
    fp32 pin."""
    q = _randn((B, Sq, H, hd), torch.float32, gen)
    k = _randn((B, Skv, KH, hd), torch.float32, gen)
    v = _randn((B, Skv, KH, hd), torch.float32, gen)
    before = ops.ROUTE_LAUNCHES["flash_attention"]["tf32x3"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.ROUTE_LAUNCHES["flash_attention"]["tf32x3"] == before + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal),
                               atol=2e-5, rtol=2e-5)


def test_flash_tf32x3_kernel_reads_unaligned_strides(gen):
    """fp32 q, k, v whose base and step stride are not whole 16 bytes: the
    kernel copies them 4 bytes at a time."""
    buf = _randn((1, 64, 4 * 64 + 3), torch.float32, gen)
    q = buf[:, :, 1:257].unflatten(2, (4, 64))
    torch.testing.assert_close(ops.flash_attention(q, q, q),
                               ref.attention_ref(q, q, q),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_empty_head_blocks_launch_nothing(gen, dtype):
    """A rank holding no head: flash with H = KH = 0 and the SSD scan with
    H = 0 return the kernel's (empty) shapes and count no launch."""
    q = _randn((2, 64, 0, 128), dtype, gen)
    x = _randn((2, 64, 0, 64), dtype, gen)
    bm = _randn((2, 64, 128), dtype, gen)
    before = ({k: dict(v) for k, v in ops.ROUTE_LAUNCHES.items()},
              dict(ops.LAUNCHES))
    o = ops.flash_attention(q, q, q)
    y, h = ops.ssd_scan(x, _randn((2, 64, 0), torch.float32, gen),
                        _randn((0,), torch.float32, gen), bm, bm)
    torch.cuda.synchronize()
    assert (o.shape, y.shape, h.shape) == ((2, 64, 0, 128), (2, 64, 0, 64),
                                           (2, 0, 64, 128))
    assert (o.dtype, y.dtype, h.dtype) == (dtype, dtype, torch.float32)
    assert ({k: dict(v) for k, v in ops.ROUTE_LAUNCHES.items()},
            dict(ops.LAUNCHES)) == before


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
                                         (torch.float32, "tf32x3")])
def test_dtype_picks_the_route(gen, dtype, route):
    """bf16 launches the bf16 tensor-core kernels, fp32 the 3xTF32 ones."""
    q = _randn((1, 64, 4, 64), dtype, gen)
    args = _ssd_inputs(1, 64, 2, 16, 16, dtype, gen)
    ops.reset_launches()
    ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
    ops.ssd_scan(*args, chunk=32)
    other = {"tensor_core": "tf32x3", "tf32x3": "tensor_core"}[route]
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


@pytest.mark.parametrize("P", [16, 32, 64])
@pytest.mark.parametrize("chunk", TILES)
@pytest.mark.parametrize("S", [200, 40])   # ragged; shorter than some chunks
def test_ssd_tf32x3_kernel_fp32(gen, P, chunk, S):
    """The fp32 route (3xTF32 split products) at every head dim and chunk
    tile: y and the final state at the fp32 pin against both plain
    forms."""
    args = _ssd_inputs(2, S, 8, P, 128, torch.float32, gen)
    before = ops.ROUTE_LAUNCHES["ssd_scan"]["tf32x3"]
    y, h = ops.ssd_scan(*args, chunk=chunk)
    assert ops.ROUTE_LAUNCHES["ssd_scan"]["tf32x3"] == before + 1
    for want_y, want_h in (ref.ssd_ref(*args),
                           ref.ssd_chunked(*args, chunk=chunk)):
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)


def test_ssd_tf32x3_kernel_reads_unaligned_strides(gen):
    """fp32 B and C whose bases are not 16-byte aligned: the kernel copies
    them 4 bytes at a time."""
    x, dt, a_neg, _, _ = _ssd_inputs(1, 64, 2, 16, 16, torch.float32, gen)
    buf = _randn((1, 64, 21), torch.float32, gen)
    args = (x, dt, a_neg, buf[:, :, 1:17], buf[:, :, 2:18])
    y, h = ops.ssd_scan(*args, chunk=32)
    want_y, want_h = ref.ssd_ref(*args)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
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


def _backward_case(kernel, dtype, gen):
    """(ops call, plain call, inputs, pin) at a small ragged shape."""
    if kernel == "flash_attention":
        inputs = [_randn((2, 200, n, 64), dtype, gen) for n in (8, 2, 2)]
        return (ops.flash_attention,
                lambda q, k, v: ref.blockwise_attention(
                    q, k, v, chunk=min(512, k.shape[1]), causal=True),
                inputs, FLASH_TOL[dtype])
    if kernel == "rmsnorm":
        inputs = [_randn((64, 1024), dtype, gen),
                  1.0 + 0.1 * _randn((1024,), torch.float32, gen)]
        return ops.rmsnorm, ref.rmsnorm_ref, inputs, NORM_TOL[dtype]
    inputs = list(_ssd_inputs(2, 200, 4, 32, 64, dtype, gen))
    return (lambda *a: ops.ssd_scan(*a, chunk=64),
            lambda *a: ref.ssd_chunked(*a, chunk=64), inputs, SSD_TOL[dtype])


@pytest.mark.parametrize("kernel", ["flash_attention", "rmsnorm", "ssd_scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_autograd(gen, kernel, dtype):
    """The grads of every input through ``ops.<kernel>`` (the kernel's
    forward, launched once; the recompute backward) equal the plain
    function's own autograd; the SSD carries a cotangent for y and for the
    final state."""
    call, plain, inputs, tol = _backward_case(kernel, dtype, gen)
    xs = [t.detach().requires_grad_() for t in inputs]
    before = ops.LAUNCHES[kernel]
    outs = call(*xs)
    assert ops.LAUNCHES[kernel] == before + 1
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [_randn(o.shape, o.dtype, gen) for o in outs]
    got = torch.autograd.grad(outs, xs, cots)
    want_outs = plain(*xs)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    want = torch.autograd.grad(want_outs, xs, cots)
    assert ops.LAUNCHES[kernel] == before + 1      # no kernel in backward
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == xs[i].dtype
        torch.testing.assert_close(g, w, atol=tol, rtol=tol,
                                   msg=f"input {i}")


def test_train_two_steps_card_vs_host(gen):
    """Two AdamW steps of reduced glm4-9b in fp32 on the card (3xTF32
    flash, Triton norm) and on the host from the same params: losses within
    1e-4, params within the fp32 parity pin 1e-3, and one flash launch a
    layer and 2 norms a layer plus the final one a step."""
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")), grad_accum=1)
    params = init_params(cfg, gen, "cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=72,
                                  global_batch=4, seed=0))
    states, losses = {}, {}
    for device in ("cuda", "cpu"):
        opt = make_optimizer(cfg.optimizer, total_steps=10, base_lr=1e-3)
        step = build_train_step(cfg, opt)
        state = init_train_state(
            cfg, {k: t.detach().clone().to(device) for k, t in
                  params.items()}, opt)
        ops.reset_launches()
        losses[device] = []
        for i in range(2):
            state, met = step(state, data.batch(i))
            assert met["skipped"] == 0
            losses[device].append(float(met["loss"]))
        states[device] = state
        if device == "cuda":
            assert ops.LAUNCHES == {"flash_attention": 2 * cfg.num_layers,
                                    "rmsnorm": 2 * (2 * cfg.num_layers + 1),
                                    "ssd_scan": 0}
    torch.testing.assert_close(torch.tensor(losses["cuda"]),
                               torch.tensor(losses["cpu"]),
                               atol=1e-4, rtol=1e-4)
    for name, p in states["cpu"]["params"].items():
        torch.testing.assert_close(states["cuda"]["params"][name].cpu(), p,
                                   atol=1e-3, rtol=1e-3, msg=name)


# ---------------------------------------------------------------------------
# jamba-v0.1-52b's shapes and its MoE FFN (chip_smoke.py phase 12 (a), (b)).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(4, 8192), (4096, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_at_jamba_gated_width(gen, rows, d, dtype):
    """jamba's gated norm over d_inner 8192 (its own Triton
    specialisation)."""
    x = _randn((rows, d), dtype, gen)
    w = 1.0 + 0.1 * _randn((d,), torch.float32, gen)
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                               atol=tol, rtol=tol)


def test_ssd_tensor_core_kernel_at_jamba_shape(gen):
    """bf16, B 4, S 1024, H 128, P 64, N 16, chunk 64, dt and A as the
    block draws them: y against the plain chunked form at the bf16 pin,
    the state at the fp32 pin (both formed in fp32)."""
    B, S, H, P, N = 4, 1024, 128, 64, 16
    dt = F.softplus(_randn((B, S, H), torch.float32, gen))
    a_neg = -torch.exp(torch.rand((H,), generator=gen, device="cuda")
                       * math.log(16.0))
    bf16 = torch.bfloat16
    args = (_randn((B, S, H, P), bf16, gen), dt, a_neg,
            _randn((B, S, N), bf16, gen), _randn((B, S, N), bf16, gen))
    before = ops.ROUTE_LAUNCHES["ssd_scan"]["tensor_core"]
    y, h = ops.ssd_scan(*args, chunk=64)
    assert ops.ROUTE_LAUNCHES["ssd_scan"]["tensor_core"] == before + 1
    want_y, want_h = ref.ssd_chunked(*args, chunk=64)
    torch.testing.assert_close(y.float(), want_y.float(), atol=SSD_TOL[bf16],
                               rtol=SSD_TOL[bf16])
    torch.testing.assert_close(h, want_h, atol=SSD_TOL[torch.float32],
                               rtol=SSD_TOL[torch.float32])


def test_flash_tensor_core_kernel_gqa_group_4(gen):
    """jamba's attention: 32 query heads over 8 KV heads, hd 128, causal,
    B 4, S 1024, bf16 on the tensor-core route."""
    bf16 = torch.bfloat16
    q = _randn((4, 1024, 32, 128), bf16, gen)
    k, v = (_randn((4, 1024, 8, 128), bf16, gen) for _ in range(2))
    before = ops.ROUTE_LAUNCHES["flash_attention"]["tensor_core"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.ROUTE_LAUNCHES["flash_attention"]["tensor_core"] == before + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True),
                               atol=FLASH_TOL[bf16], rtol=FLASH_TOL[bf16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_kimi_head_dim_112(gen, dtype):
    """kimi-k2-1t-a32b's attention: 64 query heads of 112 over 8 KV heads,
    causal, B 1, S 1024, on the dtype's route (the bf16 kernel lays the
    head out at 128 columns, TMA zero-filling the last 16)."""
    q = _randn((1, 1024, 64, 112), dtype, gen)
    k, v = (_randn((1, 1024, 8, 112), dtype, gen) for _ in range(2))
    route = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    before = ops.ROUTE_LAUNCHES["flash_attention"][route]
    got = ops.flash_attention(q, k, v, causal=True)
    assert ops.ROUTE_LAUNCHES["flash_attention"][route] == before + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True),
                               atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def test_virtual_ring_matches_blockwise_on_the_card(gen):
    """Four virtual ctx ranks composed from ``ring_hop`` in the ring's hop
    order against ``blockwise_attention`` on the whole sequence, fp32,
    forward (2e-5) and vjp (rtol 5e-4, atol 5e-5), at a small width with a
    ragged last chunk."""
    from repro_torch.core import ring_attention as ring
    B, S, H, KH, hd, cp, chunk = 2, 320, 8, 2, 64, 4, 48
    qkv = [_randn((B, S, n, hd), torch.float32, gen).requires_grad_()
           for n in (H, KH, KH)]
    g = _randn((B, S, H, hd), torch.float32, gen)
    s = S // cp

    def virtual(q, k, v):
        qs, ks, vs = (t.split(s, dim=1) for t in (q, k, v))
        outs = []
        for r in range(cp):
            carry = ring.ring_init(qs[r])
            for t in range(cp):
                src = (r - t) % cp
                carry = ring.ring_hop(carry, qs[r], ks[src], vs[src],
                                      q_pos0=r * s, kv_base=src * s,
                                      chunk=chunk)
            outs.append(ring.ring_finish(carry, q.dtype))
        return torch.cat(outs, dim=1)

    got = virtual(*qkv)
    want = ref.blockwise_attention(*qkv, chunk=chunk)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(torch.autograd.grad(got, qkv, g),
                    torch.autograd.grad(want, qkv, g)):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=5e-4)


def test_moe_ffn_full_width_card_matches_host(gen):
    """jamba's MoE FFN at full width (E 16, top-2, d 4096, h 14336), fp32,
    T 512, card vs host: y and the grads of ``sum(y * c) + aux`` (x, the
    router, the expert weights) within 1e-3 of each one's largest |value|,
    aux within 1e-5 relative, the same top-k choices and kept slots."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), dtype="float32")
    p = moe.moe_init(cfg, torch.float32, gen)
    x = _randn((1, 512, cfg.d_model), torch.float32, gen)
    cot = _randn((1, 512, cfg.d_model), torch.float32, gen)

    def run(pp, xx, cc):
        leaves = {k: v.detach().requires_grad_() for k, v in pp.items()}
        xx = xx.detach().requires_grad_()
        y, aux = moe.moe_apply(xx, leaves, cfg, None)
        probs = torch.softmax(xx[0].detach() @ pp["router"], dim=-1)
        idx = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
        cap = math.ceil(512 * cfg.experts_per_token / cfg.num_experts
                        * cfg.capacity_factor)
        keep = moe.dispatch_plan(idx, cfg.num_experts, cap)[2]
        grads = torch.autograd.grad((y * cc).sum() + aux,
                                    [xx] + list(leaves.values()))
        return ([y.detach(), *grads], aux.detach(), idx, keep)

    card = run(p, x, cot)
    host = run({k: v.cpu() for k, v in p.items()}, x.cpu(), cot.cpu())
    assert torch.equal(card[2].cpu(), host[2])
    assert torch.equal(card[3].cpu(), host[3])
    torch.testing.assert_close(card[1].cpu(), host[1], atol=0, rtol=1e-5)
    for a, b in zip(card[0], host[0]):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-3 * float(b.abs().max()), err


# ---------------------------------------------------------------------------
# The paper's primitives over NCCL (launch/dist_check.py), one rank per card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA mesh runs NCCL on the card")
    return torch.cuda.device_count()


def _dist_suite(world):
    ranks = mesh.spawn(functools.partial(dist_check.run,
                                         shapes=dist_check.SMALL), world,
                       device="cuda", timeout_s=300)
    for res in ranks:
        assert res["backend"] == "nccl" and res["world"] == world
        assert not res["failed"], {c: res["rel_err"][c]
                                   for c in res["failed"]}
        assert len(res["rel_err"]) == 47
    return ranks


def test_dist_suite_over_nccl(cards):
    """Every primitive, LinearOp (and adjoint) and memory operator passes
    Eq. 13 on CUDA tensors in a world of one NCCL rank per card."""
    _dist_suite(cards)


def test_dist_suite_across_two_cards(cards):
    """The same suite where the collectives cross cards: two ranks, two
    cards."""
    if cards < 2:
        pytest.skip(f"needs at least 2 cards, found {cards}: NCCL takes one "
                    f"rank per card, so a multi-rank NCCL world waits for a "
                    f"multi-card machine")
    _dist_suite(2)


def _shift_offset_two(rank, world_mesh):
    """send_recv by +2 on a non-cyclic axis of 3 ranks: rank 1 has neither
    a source nor a destination and posts no p2p operation."""
    m = mesh.make_host_mesh((3,), ("model",), device="cuda")
    with prim.use_mesh(m):
        x = torch.full((4,), float(rank + 1), device="cuda",
                       requires_grad=True)
        y = prim.send_recv(x, "model", 2)
        (g,) = torch.autograd.grad(
            y, x, torch.full((4,), 10.0 * (rank + 1), device="cuda"))
    return {"y": y.detach(), "g": g}


def test_send_recv_offset_two_across_three_cards(cards):
    if cards < 3:
        pytest.skip(f"needs at least 3 cards, found {cards}: the shift that "
                    f"leaves a rank out of the p2p batch needs three ranks")
    ranks = mesh.spawn(_shift_offset_two, 3, device="cuda", timeout_s=120)
    assert [float(r["y"][0]) for r in ranks] == [0.0, 0.0, 1.0]
    assert [float(r["g"][0]) for r in ranks] == [30.0, 0.0, 0.0]


def _hybrid_on_card(rank, world_mesh, *, cfg, steps, batch, seq, micro):
    """Two hybrid AdamW steps at mesh (1, 1, 1) through the CLI's per-rank
    path, with the launch counts around them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.reset_launches()
    state, hist, _ = launch_train.train_hybrid_rank(
        cfg, (1, 1, 1, 1, 1), steps=steps, batch=batch, seq=seq,
        microbatches=micro, lr=1e-3, seed=0, device="cuda",
        logger=lambda *a: None)
    return {"losses": [r["loss"] for r in hist],
            "skipped": [r["skipped"] for r in hist],
            "launches": dict(ops.LAUNCHES), "params": state["params"]}


def test_hybrid_step_card_vs_host(cards):
    """The hybrid executor on one NCCL rank (mesh (1, 1, 1), 2
    microbatches) against the single-device step on the host from the same
    params and batches: two AdamW steps of reduced glm4-9b in fp32, losses
    within 1e-4 and params within 1e-3 (the card-vs-host pins above); M x
    L flash and M x (2L + 1) norm launches a step (the last stage skips
    its F ticks, so every launch is on a B tick)."""
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")), grad_accum=1)
    run = dict(steps=2, batch=4, seq=72, micro=2)
    got = mesh.spawn(functools.partial(_hybrid_on_card, cfg=cfg, **run), 1,
                     device="cuda", timeout_s=300)[0]
    L, M = cfg.num_layers, run["micro"]
    assert got["launches"] == {"flash_attention": 2 * M * L,
                               "rmsnorm": 2 * M * (2 * L + 1),
                               "ssd_scan": 0}
    assert got["skipped"] == [0, 0]
    # the per-rank path draws the global tree on the host (seed 0)
    params = from_pipeline_params(init_pipeline_params(
        cfg, torch.Generator().manual_seed(0), 1, "cpu"))
    opt = make_optimizer(cfg.optimizer, total_steps=run["steps"],
                         base_lr=1e-3)
    state = init_train_state(cfg, params, opt)
    step = build_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=run["seq"],
                                  global_batch=run["batch"], seed=0))
    losses = []
    for i in range(run["steps"]):
        state, met = step(state, data.batch(i))
        losses.append(float(met["loss"]))
    torch.testing.assert_close(torch.tensor(got["losses"]),
                               torch.tensor(losses), atol=1e-4, rtol=1e-4)
    card = from_pipeline_params({k: torch.from_numpy(v)
                                 for k, v in got["params"].items()})
    for name, p in state["params"].items():
        torch.testing.assert_close(card[name], p, atol=1e-3, rtol=1e-3,
                                   msg=name)


def test_cuda_mesh_refuses_more_ranks_than_cards(cards):
    with pytest.raises(ValueError, match="one rank per card"):
        mesh.spawn(dist_check.run, cards + 1, device="cuda", timeout_s=60)
