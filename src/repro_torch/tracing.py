"""The registry of active shape traces, and the two hooks the layers
below the trace call: a hand-written kernel call (``kernels/ops.py``) and
a collective (``core/primitives.py``).

The trace itself, and every report over it, lives in
``roofline/hlo_profile.py``; this module imports nothing, so the kernels
and the primitives depend on the registry only.  With no trace active a
hook costs one list check.
"""

from __future__ import annotations

TRACES: list = []        # the active traces, innermost last


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
