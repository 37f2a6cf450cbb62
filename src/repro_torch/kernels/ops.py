"""Dispatch over the kernels by the tensor's device, with gradients
(mirrors ``repro/kernels/ops.py``).

Forward: a tensor on the host goes to the plain version (``ref.py``; for the
SSD scan its chunked form ``ssd_chunked``).  A CUDA tensor launches the
hand-written kernel of its dtype (each wrapper's ``ROUTES``) or raises;
there is no switch that sends a CUDA tensor to the plain version.
``LAUNCHES`` counts every kernel launch, so a run can show that its path
went through the kernels, and ``ROUTE_LAUNCHES`` counts the launches of
flash attention and the SSD scan by route: ``tensor_core`` for bf16,
``tf32x3`` for fp32 (the TF32 tensor cores by split products).

An empty head block (no query or SSM head: a rank of a model axis larger
than the head count) has no work: on ``meta`` and on the card the wrapper
checks it and returns the empty outputs of the kernel's shapes, launches
nothing and counts nothing, and the trace records no kernel call.  On the
host the plain versions return the same empty shapes.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the shape
route: the same checks as the card's wrapper, which raise where it
raises, then empty ``meta`` outputs of the kernel's shapes.  This is shape
evaluation, not a fallback: a meta tensor holds no data, nothing is
launched or counted in ``LAUNCHES``, and the plain version is not called.
Each kernel call on ``meta`` or on the card is recorded, with its
``cost.kernel_cost``, in the active shape trace (``repro_torch/tracing.py``;
the trace is ``roofline/hlo_profile.py``'s), if there is one.

Backward: when an input requires grad under grad mode, the call goes
through a ``torch.autograd.Function`` whose forward is the dispatch above
and saves only its inputs, and whose backward recomputes through the
differentiable plain version and returns ``torch.autograd.grad`` of it, as
the reference's ``custom_vjp``s do (``repro/kernels/ops.py``): flash
attention through ``ref.blockwise_attention`` at ``chunk = min(512, Skv)``,
the SSD scan through ``ref.ssd_chunked``, RMSNorm through
``ref.rmsnorm_ref``.  The reference has no backward Pallas kernel, so the
port has no backward kernel either.  On the host the ``Function`` is used
too, so the host tests exercise its backward.  Without grad (serving runs
under ``torch.inference_mode()``) the dispatch is called directly.
"""

from __future__ import annotations

import torch

from .. import tracing
from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd
from .rmsnorm import check_inputs as _rmsnorm_check
from .cost import kernel_cost
from .rmsnorm import rmsnorm_fwd

LAUNCHES = {"flash_attention": 0, "rmsnorm": 0, "ssd_scan": 0}
ROUTE_LAUNCHES = {name: {"tensor_core": 0, "tf32x3": 0}
                  for name in ("flash_attention", "ssd_scan")}


def reset_launches():
    """Set every launch count, by kernel and by route, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTE_LAUNCHES.values():
        for route in routes:
            routes[route] = 0


def _record(name, route, ins, outs, **kw):
    """The call into the active shape trace, with its cost."""
    if tracing.active() is not None:
        tracing.record_kernel(
            name, route, ins, outs,
            kernel_cost(name, *(t.shape for t in ins), dtype=ins[0].dtype,
                        **kw))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _recompute_grads(ctx, name, plain, outputs_grad, **kwargs):
    """Grads of ``plain(*saved inputs, **kwargs)`` for the inputs that need
    them, recomputed from the saved inputs; None for the others.  The only
    read of ``ctx.saved_tensors``: under ``torch.utils.checkpoint`` they
    unpack once.  The recompute and its grads are the span
    ``kernels.<name>.bwd``."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in inputs if t.requires_grad]
    with tracing.span(f"kernels.{name}.bwd"):
        with torch.enable_grad():
            out = plain(*inputs, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, outputs_grad) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                         wanted, [g for _, g in pairs],
                                         allow_unused=True))
    return [next(grads) if t.requires_grad else None for t in inputs]


# ---------------------------------------------------------------------------

def _flash_fwd(q, k, v, causal):
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    if q.device.type == "meta" or _flash.is_empty(q):
        _flash.check_inputs(q, k, v, device=q.device.type)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        if _flash.is_empty(q):  # no head, no work: nothing to launch
            return out
    else:
        out = _flash.flash_attention_fwd(q, k, v, causal=causal)
        LAUNCHES["flash_attention"] += 1
        ROUTE_LAUNCHES["flash_attention"][_flash.ROUTES[q.dtype]] += 1
    _record("flash_attention", _flash.ROUTES[q.dtype], (q, k, v), (out,),
            causal=causal)
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    ``ref.blockwise_attention`` (``_fa_bwd``, ``repro/kernels/ops.py``),
    whose fp32 scores are (B, Sq, H, chunk), never (B, H, Sq, Skv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, min(512, k.shape[1])
        return _flash_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grads(ctx, "flash_attention",
                                  ref.blockwise_attention, (g,),
                                  chunk=ctx.chunk, causal=ctx.causal), None)


def flash_attention(q, k, v, causal=True):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) -> (B, Sq, H, hd)."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal)


# ---------------------------------------------------------------------------

def _rmsnorm_fwd(x, w, eps):
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps)
    if x.device.type == "meta":
        _rmsnorm_check(x, w, device="meta")
        out = torch.empty_like(x)
    else:
        out = rmsnorm_fwd(x, w, eps=eps)
        LAUNCHES["rmsnorm"] += 1
    _record("rmsnorm", "triton", (x, w), (out,), w_dtype=w.dtype)
    return out


class RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    ``ref.rmsnorm_ref`` (``_rms_bwd``).  w's grad comes back in w's dtype
    (fp32 for the model's norms), x's in x's."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        return (*_recompute_grads(
            ctx, "rmsnorm", lambda x, w: ref.rmsnorm_ref(x, w, ctx.eps),
            (g,)), None)


def rmsnorm(x, w, eps=1e-6):
    """RMSNorm over the last dim; x: (..., d), w: (d,)."""
    if _needs_grad(x, w):
        return RMSNorm.apply(x, w, eps)
    return _rmsnorm_fwd(x, w, eps)


# ---------------------------------------------------------------------------

def _ssd_fwd(x, dt, a_neg, Bm, Cm, chunk):
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a_neg, Bm, Cm, chunk=chunk)
    if x.device.type == "meta" or _ssd.is_empty(x):
        _ssd.check_inputs(x, dt, a_neg, Bm, Cm, chunk, device=x.device.type)
        B, S, H, P = x.shape
        out = (torch.empty((B, S, H, P), dtype=x.dtype, device=x.device),
               torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32,
                           device=x.device))
        if _ssd.is_empty(x):    # no head, no work: nothing to launch
            return out
    else:
        out = _ssd.ssd_scan_fwd(x, dt, a_neg, Bm, Cm, chunk=chunk)
        LAUNCHES["ssd_scan"] += 1
        ROUTE_LAUNCHES["ssd_scan"][_ssd.ROUTES[x.dtype]] += 1
    _record("ssd_scan", _ssd.ROUTES[x.dtype], (x, dt, a_neg, Bm, Cm), out,
            chunk=chunk)
    return out


class SSDScan(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    ``ref.ssd_chunked`` (``_ssd_bwd``), with grads for all five inputs.
    The reference's ``ssd_scan`` returns y only; this one also returns the
    final state, and carries a cotangent for both outputs (an unused
    h_final contributes nothing)."""

    @staticmethod
    def forward(ctx, x, dt, a_neg, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, a_neg, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _ssd_fwd(x, dt, a_neg, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        return (*_recompute_grads(ctx, "ssd_scan", ref.ssd_chunked,
                                  (gy, gh), chunk=ctx.chunk), None)


def ssd_scan(x, dt, a_neg, Bm, Cm, chunk=64):
    """Mamba2 SSD chunk scan.  x: (B,S,H,P); dt: (B,S,H); a_neg: (H,);
    Bm/Cm: (B,S,N) -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    if _needs_grad(x, dt, a_neg, Bm, Cm):
        return SSDScan.apply(x, dt, a_neg, Bm, Cm, chunk)
    return _ssd_fwd(x, dt, a_neg, Bm, Cm, chunk)
