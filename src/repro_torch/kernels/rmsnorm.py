"""Fused RMSNorm on Hopper: a Triton kernel.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_fwd``
(``_rmsnorm_kernel``): ``y = x * rsqrt(mean(x^2) + eps) * w`` over the last
dim, fp32 inside, output in x's dtype.

Bound: a row reduction then an elementwise scale, about 4 operations per
element and no tensor core, so it is bound by memory: each byte of x is
read once and each byte of y written once (67 MB at the prefill shape
4096 x 4096 bf16, ~20 us on an H100 SXM); at decode (4 rows) it is bound
by launch latency.  Design: one program per row, the whole row in
registers (a masked ``BLOCK_D = next_pow2(d)`` load), so x is read from
device memory once.  Triton is chosen over CUDA because a masked row load,
a ``tl.sum`` and a store reach the same memory bound in a few lines.

``triton`` is imported on the first launch, never at import: the CPU tests
import this module on a host without it.
"""

from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 1 << 16

tl = None  # triton.language, bound by _compiled() on the first launch
_jit = None


def _rmsnorm_kernel(x_ptr, w_ptr, y_ptr, d, stride_x, stride_y, eps,
                    BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask, other=0.0
                ).to(tl.float32)
    var = tl.sum(x * x, axis=0) / d
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(var + eps) * w
    tl.store(y_ptr + row * stride_y + cols, y.to(y_ptr.dtype.element_ty),
             mask=mask)


def _compiled():
    global tl, _jit
    if _jit is None:
        import triton
        import triton.language

        tl = triton.language
        _jit = triton.jit(_rmsnorm_kernel)
    return _jit


def check_inputs(x, w):
    """Raise ``ValueError`` for anything the kernel does not take."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}; the "
                         f"kernel needs both on one CUDA device")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: dtypes x {x.dtype}, w {w.dtype}; the "
                         f"kernel takes {DTYPES}")
    if x.dim() == 0 or w.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not match on the last dim")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.shape[-1] > MAX_D or x.numel() == 0:
        raise ValueError(f"rmsnorm: row length {x.shape[-1]} (at most "
                         f"{MAX_D}) and a non-empty x")


def rmsnorm_fwd(x, w, *, eps=1e-6):
    """x: (..., d) CUDA tensor; w: (d,) -> y like x.  Launches on the current
    stream and does not synchronise."""
    check_inputs(x, w)
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    block = 1 << (d - 1).bit_length()
    _compiled()[(rows,)](x, w, y, d, d, d, eps, BLOCK_D=block,
                         num_warps=max(1, min(16, block // 256)))
    return y
