"""The port's plain kernel versions and its device dispatch, held against
the JAX package: the Pallas kernels in interpret mode at a few shapes of
``tests/test_kernels.py``, and the jnp oracles (``repro.kernels.ref``) over
the rest of that sweep.  Inputs are made with numpy from a seed and handed
to both packages.

Tolerances are the reference's own pins (``tests/test_kernels.py``):
attention 2e-5 in fp32, RMSNorm 1e-5 in fp32, both 2e-2 in bf16, and 1e-4
on gradients through each kernel's autograd Function against the JAX
``custom_vjp``.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels import ops, ref

SRC = Path(__file__).resolve().parent.parent / "src"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

SHAPES = [            # (B, S, H, KH, hd), the flash sweep of test_kernels.py
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 4, 2, 64),     # GQA 2:1
    (1, 128, 8, 1, 32),     # MQA
    (1, 256, 2, 2, 128),    # wide head
]


def _inputs(shapes, seed, dtype):
    """numpy normals, rounded to ``dtype`` the same way for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a).astype(dtype),
                    torch.from_numpy(a).to(TORCH_DTYPE[dtype])))
    return out


def _close(got_torch, want_jax, tol):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,KH,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax_ref(B, S, H, KH, hd, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 0, dtype)
    _close(ref.attention_ref(qt, kt, vt, causal=causal),
           jref.attention_ref(qj, kj, vj, causal=causal), FLASH_TOL[dtype])


@pytest.mark.parametrize("B,S,H,KH,hd,dtype,causal", [
    (1, 128, 4, 4, 64, "float32", True),
    (2, 256, 4, 2, 64, "bfloat16", False),
    (1, 128, 8, 1, 32, "float32", True),
    (1, 128, 8, 1, 112, "float32", True),     # kimi-k2's head dim
    (1, 128, 8, 1, 112, "bfloat16", True),
])
def test_attention_ref_matches_pallas_interpret(B, S, H, KH, hd, dtype,
                                                causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        [(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], 1, dtype)
    want = flash_attention_fwd(qj, kj, vj, causal=causal, bq=64, bk=64,
                               interpret=True)
    _close(ref.attention_ref(qt, kt, vt, causal=causal), want,
           FLASH_TOL[dtype])


@pytest.mark.parametrize("shape", [(4, 256), (2, 8, 512), (128, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_ref_matches_jax_ref(shape, dtype):
    (xj, xt), (wj, wt) = _inputs([shape, shape[-1:]], 2, dtype)
    wj, wt = wj.astype(jnp.float32), wt.float()
    _close(ref.rmsnorm_ref(xt, wt), jref.rmsnorm_ref(xj, wj), NORM_TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [((4, 256), "float32"),
                                         ((2, 8, 512), "bfloat16")])
def test_rmsnorm_ref_matches_pallas_interpret(shape, dtype):
    (xj, xt), (wj, wt) = _inputs([shape, shape[-1:]], 3, dtype)
    wj, wt = wj.astype(jnp.float32), wt.float()
    _close(ref.rmsnorm_ref(xt, wt), rmsnorm_fwd(xj, wj, interpret=True),
           NORM_TOL[dtype])


def test_ops_on_host_tensors_take_plain_versions():
    """A CPU tensor goes to the plain version, and no launch is counted."""
    (_, q), (_, k), (_, v), (_, x), (_, w) = _inputs(
        [(1, 64, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32), (3, 64), (64,)], 4,
        "float32")
    ops.reset_launches()
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.attention_ref(q, k, v))
    assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    xs, bm = torch.randn((1, 40, 2, 16)), torch.randn((1, 40, 16))
    dt, a_neg = torch.rand((1, 40, 2)) * 0.1, -torch.rand((2,)) - 0.5
    y, h = ops.ssd_scan(xs, dt, a_neg, bm, bm, chunk=16)
    y_ref, h_ref = ref.ssd_ref(xs, dt, a_neg, bm, bm)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    assert ops.LAUNCHES == {"flash_attention": 0, "rmsnorm": 0,
                            "ssd_scan": 0}


def _no_plain(monkeypatch):
    """Make every plain forward raise: an off-host call must not reach it."""
    def refuse(*a, **k):
        raise AssertionError("an off-host tensor reached the plain version")
    for name in ("attention_ref", "rmsnorm_ref", "ssd_chunked"):
        monkeypatch.setattr(ref, name, refuse)


def test_ops_off_host_reach_the_kernel_wrappers(monkeypatch):
    """A tensor that is not on the host never falls back to the plain
    version: it reaches the kernel wrapper's checks.  The wrapper refuses a
    non-CUDA device; a ``meta`` tensor (the dry run) takes the same checks
    through ``ops``' shape route, which refuses what the card refuses,
    returns empty outputs of the kernel's shapes and launches nothing."""
    from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
    _no_plain(monkeypatch)
    ops.reset_launches()
    q = torch.empty((1, 64, 4, 32), device="meta")
    k = torch.empty((1, 64, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.check_inputs(q, k, k)
    assert ops.flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="head dim 8"):
        ops.flash_attention(q[..., :8], k[..., :8], k[..., :8])
    x, w = torch.empty((3, 64), device="meta"), torch.empty((64,),
                                                             device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.check_inputs(x, w)
    assert ops.rmsnorm(x, w).shape == x.shape
    with pytest.raises(ValueError, match="do not match"):
        ops.rmsnorm(x, w[:32])
    xs = torch.empty((1, 64, 2, 16), device="meta")
    bm = torch.empty((1, 64, 16), device="meta")
    dt, a = torch.empty((1, 64, 2), device="meta"), torch.empty(
        (2,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.check_inputs(xs, dt, a, bm, bm, 64)
    y, h = ops.ssd_scan(xs, dt, a, bm, bm)
    assert (y.shape, h.shape) == (xs.shape, (1, 2, 16, 16))
    with pytest.raises(ValueError, match="head dim 8"):
        ops.ssd_scan(xs[..., :8], dt, a, bm, bm)
    assert ops.LAUNCHES == {"flash_attention": 0, "rmsnorm": 0,
                            "ssd_scan": 0}


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


@pytest.mark.parametrize("kernel", ["flash_attention", "rmsnorm", "ssd_scan"])
def test_ops_off_host_with_grad_reach_the_kernel_wrappers(kernel,
                                                          monkeypatch):
    """A tensor off the host that requires grad goes through the kernel's
    autograd Function to the kernel wrapper's checks, under grad mode and
    under no_grad alike: never to the plain forward.  On ``meta`` the
    checks refuse a head dim the kernel does not take, and a valid call's
    output carries the Function's backward under grad mode only."""
    _no_plain(monkeypatch)
    args = {
        "flash_attention": lambda g, d: (_meta(1, 64, 4, d, grad=g),
                                         _meta(1, 64, 2, d),
                                         _meta(1, 64, 2, d)),
        "rmsnorm": lambda g, d: (_meta(3, d), _meta(d if d != 8 else 9,
                                                    grad=g)),
        "ssd_scan": lambda g, d: (_meta(1, 64, 2, d, grad=g),
                                  _meta(1, 64, 2), _meta(2),
                                  _meta(1, 64, 16), _meta(1, 64, 16)),
    }[kernel]
    fn = getattr(ops, kernel)
    function = {"flash_attention": "FlashAttention", "rmsnorm": "RMSNorm",
                "ssd_scan": "SSDScan"}[kernel]
    with pytest.raises(ValueError):
        fn(*args(True, 8))
    with torch.no_grad(), pytest.raises(ValueError):
        fn(*args(True, 8))
    with pytest.raises(ValueError):
        fn(*args(False, 8))
    out = fn(*args(True, 16))
    out = out[0] if isinstance(out, tuple) else out
    assert type(out.grad_fn).__name__ == f"{function}Backward"
    with torch.no_grad():
        out = fn(*args(True, 16))
    assert (out[0] if isinstance(out, tuple) else out).grad_fn is None


def _grad_case(kernel, rng):
    """(port fn, plain torch fn, JAX fn of impl, numpy inputs) for one
    kernel at a small shape."""
    if kernel == "flash_attention":
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))]
        return (ops.flash_attention, ref.attention_ref,
                lambda impl: lambda *a: jops.flash_attention(*a, True, impl),
                arrays)
    if kernel == "rmsnorm":
        arrays = [rng.standard_normal(s).astype(np.float32)
                  for s in ((2, 8, 64), (64,))]
        return (ops.rmsnorm, ref.rmsnorm_ref,
                lambda impl: lambda *a: jops.rmsnorm(*a, 1e-6, impl), arrays)
    B, S, H, P, N = 1, 64, 2, 16, 16
    arrays = [rng.standard_normal((B, S, H, P)).astype(np.float32),
              (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
               ).astype(np.float32),
              -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32),
              rng.standard_normal((B, S, N)).astype(np.float32),
              rng.standard_normal((B, S, N)).astype(np.float32)]
    return (lambda *a: ops.ssd_scan(*a, chunk=16)[0],
            lambda *a: ref.ssd_ref(*a)[0],
            lambda impl: lambda *a: jops.ssd_scan(*a, 16, impl), arrays)


@pytest.mark.parametrize("kernel,impl", [
    ("flash_attention", "xla"), ("flash_attention", "pallas_interpret"),
    ("rmsnorm", "xla"), ("rmsnorm", "pallas_interpret"),
    ("ssd_scan", "xla"), ("ssd_scan", "pallas_interpret"),
])
def test_ops_grads_match_jax_custom_vjp(kernel, impl):
    """On the host, the grads of every input through ``ops.<kernel>``'s
    autograd Function equal the JAX ``custom_vjp``'s (forward by ``impl``,
    backward recomputed through the XLA oracle) and the plain function's
    own autograd, at the reference's VJP pin (1e-4,
    ``tests/test_kernels.py``)."""
    rng = np.random.default_rng(7)
    port_fn, plain_fn, jax_fn, arrays = _grad_case(kernel, rng)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = port_fn(*inputs)
    assert out.grad_fn is not None
    cot = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(cot))
    plain = torch.autograd.grad(plain_fn(*inputs), inputs,
                                torch.from_numpy(cot))
    _, vjp = jax.vjp(jax_fn(impl), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(cot))
    for i, (g, p, w) in enumerate(zip(got, plain, want)):
        _close(g, w, 1e-4)
        torch.testing.assert_close(g, p, atol=1e-4, rtol=1e-4,
                                   msg=f"input {i}")


def test_importing_ops_does_not_import_triton():
    code = ("import sys, repro_torch.kernels.ops; "
            "assert 'triton' not in sys.modules, 'triton imported'")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("module", ["flash_attention", "ssd_scan"])
def test_route_is_a_rule_on_the_dtype(module):
    """bf16 takes the bf16 tensor-core kernel and fp32 the 3xTF32 one; no
    other dtype has a route, and host calls count on neither."""
    wrapper = importlib.import_module(f"repro_torch.kernels.{module}")
    assert wrapper.ROUTES == {torch.bfloat16: "tensor_core",
                              torch.float32: "tf32x3"}
    half = torch.empty((1, 64, 2, 16), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match="dtypes"):
        if module == "flash_attention":
            wrapper.check_inputs(half, half, half, device="meta")
        else:
            bm = torch.empty((1, 64, 16), dtype=torch.float16, device="meta")
            dt = torch.empty((1, 64, 2), device="meta")
            wrapper.check_inputs(half, dt, dt[0, 0], bm, bm, 64,
                                 device="meta")
    ops.reset_launches()
    xs, bm = torch.randn((1, 40, 2, 16)), torch.randn((1, 40, 16))
    ops.ssd_scan(xs, torch.rand((1, 40, 2)), -torch.rand((2,)), bm, bm)
    ops.flash_attention(xs, xs, xs)
    assert ops.ROUTE_LAUNCHES == {
        name: {"tensor_core": 0, "tf32x3": 0}
        for name in ("flash_attention", "ssd_scan")}
