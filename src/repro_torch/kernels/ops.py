"""Dispatch over the kernels by the tensor's device (mirrors ``repro/kernels/ops.py``).

A tensor on the host goes to the plain version (``ref.py``; for the SSD
scan its chunked form ``ssd_chunked``).  A CUDA tensor launches the
hand-written kernel of its dtype (each wrapper's ``ROUTES``) or raises;
there is no switch that sends a CUDA tensor to the plain version.
``LAUNCHES`` counts every kernel launch, so a run can show that its path
went through the kernels, and ``ROUTE_LAUNCHES`` counts the launches of
flash attention and the SSD scan by route: ``tensor_core`` for bf16,
``cuda_core`` for fp32.

Forward only: serving needs no gradient.  So a tensor off the host that
requires grad, under grad mode, raises ``RuntimeError`` instead of losing
its gradient silently; host tensors flow through the differentiable plain
versions.  The training path (ROADMAP Queue 1, "Slice 3") wraps the kernels
in ``torch.autograd.Function``s whose backward recomputes through the plain
version, as ``repro/kernels/ops.py`` does with ``custom_vjp``.
"""

from __future__ import annotations

import torch

from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd
from .rmsnorm import rmsnorm_fwd

LAUNCHES = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}
ROUTE_LAUNCHES = {name: {"tensor_core": 0, "cuda_core": 0}
                  for name in ("flash_attention", "ssd_scan")}


def reset_launches():
    """Set every launch count, by kernel and by route, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTE_LAUNCHES.values():
        for route in routes:
            routes[route] = 0


def _forward_only(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel is forward-only and would drop the gradient; "
            "its backward comes with the training path (ROADMAP Queue 1, "
            "\"Slice 3\").  Run under torch.no_grad() or on host tensors.")


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) -> (B, Sq, H, hd)."""
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    _forward_only("flash_attention", q, k, v)
    out = _flash.flash_attention_fwd(q, k, v, causal=causal)
    LAUNCHES["flash_attention"] += 1
    ROUTE_LAUNCHES["flash_attention"][_flash.ROUTES[q.dtype]] += 1
    return out


def rmsnorm(x, w, eps=1e-6):
    """RMSNorm over the last dim; x: (..., d), w: (d,)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    _forward_only("rmsnorm", x, w)
    out = rmsnorm_fwd(x, w, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def ssd_scan(x, dt, a_neg, Bm, Cm, chunk=64):
    """Mamba2 SSD chunk scan.  x: (B,S,H,P); dt: (B,S,H); a_neg: (H,);
    Bm/Cm: (B,S,N) -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a_neg, Bm, Cm, chunk=chunk)
    _forward_only("ssd_scan", x, dt, a_neg, Bm, Cm)
    out = _ssd.ssd_scan_fwd(x, dt, a_neg, Bm, Cm, chunk=chunk)
    LAUNCHES["ssd_scan"] += 1
    ROUTE_LAUNCHES["ssd_scan"][_ssd.ROUTES[x.dtype]] += 1
    return out
