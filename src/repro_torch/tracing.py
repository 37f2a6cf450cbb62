"""The registry of active shape traces, and the two hooks the layers
below the trace call: a hand-written kernel call (``kernels/ops.py``) and
a collective (``core/primitives.py``).

The trace itself, and every report over it, lives in
``roofline/hlo_profile.py``; this module imports nothing but torch, so the
kernels and the primitives depend on the registry only.  With no trace
active a hook costs one list check.

The second kind of hook is ``span(name)``, a named time range on the
profiler's clock: the optimizer update (``optim.update``), a kernel's
recomputed backward (``kernels.<kernel>.bwd``), the serving engine's
prefill and decode step (``serve.prefill``, ``serve.decode_step``) and
each sublayer's mixer and FFN (``model.attn``, ``model.ssm``,
``model.ffn``).  It records only while a ``torch.profiler`` run is
recording on the calling thread (the autograd engine's threads inherit
it); otherwise it costs one check of the profiler's state.
"""

from __future__ import annotations

import contextlib

import torch

TRACES: list = []        # the active traces, innermost last
_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context naming the time range it holds ``name`` in the profiler's
    trace (a ``user_annotation`` event) while the profiler records; else
    one shared context that does nothing."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def active():
    """The innermost active trace, or None."""
    return TRACES[-1] if TRACES else None


def record_kernel(name: str, route: str, ins, outs, cost: dict):
    """A hand-written kernel call into the active trace (no-op without
    one): its operations and bytes are ``cost`` (``kernels.cost``)."""
    tr = active()
    if tr is not None:
        tr.add("kernel", name, ins, outs, in_bytes=cost["bytes"],
               flops=cost["flops"], route=route)


def record_collective(kind: str, axis: str, ranks, x, out, dim=None):
    """A collective into the active trace (no-op without one): ``kind`` in
    the reference's names (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute), the mesh ``axis`` and its group's
    global ``ranks``, input ``x`` and output ``out``."""
    tr = active()
    if tr is not None:
        tr.add("collective", kind, [x], [out],
               out_bytes=out.numel() * out.element_size(),
               axis=axis, ranks=tuple(ranks), dim=dim)
