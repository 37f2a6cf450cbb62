"""Dispatch over the kernels by the tensor's device (mirrors ``repro/kernels/ops.py``).

A tensor on the host goes to the plain version in ``ref.py``.  A CUDA
tensor launches the hand-written kernel or raises; there is no switch that
sends a CUDA tensor to the plain version.  ``LAUNCHES`` counts every kernel
launch, so a run can show that its path went through the kernels.

Forward only: serving needs no gradient.  The training path wraps these in
``torch.autograd.Function``s whose backward recomputes through the plain
version, as ``repro/kernels/ops.py`` does with ``custom_vjp``.
"""

from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_fwd
from .rmsnorm import rmsnorm_fwd

LAUNCHES = {"flash_attention": 0, "rmsnorm": 0}


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) -> (B, Sq, H, hd)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    out = flash_attention_fwd(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


def rmsnorm(x, w, eps=1e-6):
    """RMSNorm over the last dim; x: (..., d), w: (d,)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    out = rmsnorm_fwd(x, w, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return out
