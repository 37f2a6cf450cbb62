"""The port's plain kernel versions and its device dispatch, held against
the JAX package: the Pallas kernels in interpret mode at a few shapes of
``tests/test_kernels.py``, and the jnp oracles (``repro.kernels.ref``) over
the rest of that sweep.  Inputs are made with numpy from a seed and handed
to both packages.

Tolerances are the reference's own pins (``tests/test_kernels.py``):
attention 2e-5 in fp32, RMSNorm 1e-5 in fp32, both 2e-2 in bf16.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    assert ops.LAUNCHES == {"flash_attention": 0, "rmsnorm": 0}


def test_ops_off_host_reach_the_kernel_wrappers():
    """A tensor that is not on the host never falls back to the plain
    version: it reaches the kernel wrapper, which refuses a non-CUDA device."""
    q = torch.empty((1, 64, 4, 32), device="meta")
    k = torch.empty((1, 64, 2, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(torch.empty((3, 64), device="meta"),
                    torch.empty((64,), device="meta"))


def test_importing_ops_does_not_import_triton():
    code = ("import sys, repro_torch.kernels.ops; "
            "assert 'triton' not in sys.modules, 'triton imported'")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
