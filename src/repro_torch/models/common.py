"""Shared model components: norms, RoPE, MLPs, initialization
(mirrors ``repro/models/common.py``).

Parameters are flat ``{name: Tensor}`` dicts whose names are the JAX
pytree's key paths joined by dots (``blocks.pos0.attn.wq``); weights keep
the ``(d_in, d_out)`` layout.  ``subtree`` takes the part under a prefix.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import primitives as prim
from repro_torch.core.partition import balanced_split, shard_offsets
from repro_torch.kernels import ops
from repro_torch.tree import subtree  # noqa: F401  (re-exported)


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm in fp32, through the kernel dispatch (``kernels/ops.py``)."""
    return ops.rmsnorm(x, w, eps)


def rmsnorm_sharded(x, w, axis, d: int, eps: float = 1e-6):
    """RMSNorm with the FEATURE dim sharded over ``axis`` (the explicit-TP
    residual layout): the mean of squares over the global width ``d`` is
    assembled in fp32 with the paper's sum-reduce R over ``axis``; x and
    w are this rank's blocks of it, equal or, where the axis does not
    divide ``d``, the balanced split's.  Call inside a ``dist_jit`` region.

    The sum is ``all_reduce``: inside a region a replicated result's
    cotangent is a per-rank contribution (``core/compile.py``), and the
    reference's ``sum_reduce`` is psum both ways
    (``repro/core/primitives.py:107-123``), which is the port's
    ``all_reduce``, not its explicit-copy ``sum_reduce``.  The plain
    kernel-free form, as in the reference: the kernel normalises whole rows.
    """
    xf = x.float()
    ss = prim.all_reduce((xf * xf).sum(-1, keepdim=True), axis)
    out = xf * torch.rsqrt(ss / d + eps)
    return (out * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# The policy train program's data movement (``forward`` under a policy with
# ``seq_shard``): ZeRO-3 gathers of weight blocks and the sequence-parallel
# boundaries of the residual.  Every function runs on this rank's tensors
# inside a region (``core/compile.py::region``), where a replicated value's
# cotangent is a per-rank contribution.
# ---------------------------------------------------------------------------

def spec_axes(entry) -> tuple:
    """The mesh axes one entry of a ``PartitionSpec`` names: ``()``,
    ``(axis,)`` or the tuple itself."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_names(spec, dim: int, axis) -> bool:
    """Whether ``spec`` (a ``PartitionSpec``) splits ``dim`` over ``axis``."""
    return dim < len(spec) and axis in spec_axes(spec[dim])


def gather_block(w, spec, axes):
    """``w``, this rank's block of a weight laid out by ``spec``, gathered
    along every dim that ``spec`` splits over one of ``axes`` (the ZeRO-3
    gather, the paper's broadcast B, right before the weight is used; its
    adjoint reduce-scatters the gradient back onto the block, R).  A dim
    split over several axes (``("pod", "data")``) is gathered minor axis
    first, so its blocks land in the spec's order.  Axes of size 1 move
    nothing."""
    for d in range(len(spec)):
        for a in reversed(spec_axes(spec[d])):
            if a in axes and prim.axis_size(a) > 1:
                w = prim.all_gather(w, a, d)
    return w


def seq_gather(h, axis, seq: int):
    """The sequence-sharded residual ``h`` (B, S_loc, ...) gathered whole
    over ``axis`` (B, ``seq``, ...) before a sublayer's column-parallel
    projections; its adjoint reduce-scatters the contributions.  The
    blocks are the balanced split of ``seq`` (equal where the axis
    divides it)."""
    tp = prim.axis_size(axis)
    return prim.all_gather(h, axis, 1, balanced_split(seq, tp)) \
        if tp > 1 else h


def seq_scatter(y, axis, partial: bool):
    """A sublayer's (B, S, d) output back onto this rank's sequence block
    over ``axis`` (the balanced split of S): reduce-scattered when each
    rank holds a partial sum (a row-parallel projection), sliced when
    every rank computed the whole (a width the axis does not split; the
    slice's adjoint zero-pads).  The result is contiguous: the RMSNorm
    kernel takes whole rows."""
    tp = prim.axis_size(axis)
    if tp == 1:
        return y
    if partial:
        return prim.reduce_scatter(y, axis, 1,
                                     balanced_split(y.shape[1], tp))
    offs = shard_offsets(y.shape[1], tp)
    me = prim.axis_index(axis)
    return y.narrow(1, offs[me], offs[me + 1] - offs[me]).contiguous()


def mlp_apply_sp(h, p, specs, mlp_type: str, policy, fsdp_axes, seq: int):
    """The dense FFN (or the shared experts') on this rank's d_ff block:
    ``h`` (B, S_loc, d) normed and sequence-sharded (``seq`` the global
    length), ``p`` this rank's blocks laid out by ``specs`` (each leaf's
    spec without the stack dim).  The sequence is gathered, the up / gate
    blocks are column-parallel and w_down's row block reduce-scatters the
    partial sums back onto the sequence shard."""
    ax = policy.model_axis
    x = seq_gather(h, ax, seq)
    up = x @ gather_block(p["w_up"], specs["w_up"], fsdp_axes)
    if mlp_type == "swiglu":
        up = F.silu(x @ gather_block(p["w_gate"], specs["w_gate"],
                                     fsdp_axes)) * up
    else:
        up = F.gelu(up, approximate="tanh")
    y = up @ gather_block(p["w_down"], specs["w_down"], fsdp_axes)
    return seq_scatter(y, ax, spec_names(specs["w_up"], 1, ax))


def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """Rotary embedding.  x: (B, S, H, hd); positions: (B, S) integer.

    Uses the half-split pairing (i, i+hd/2).  Computed in fp32.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(x, p: dict, mlp_type: str):
    """Dense FFN: SwiGLU or GeLU (tanh approximation, as ``jax.nn.gelu``)."""
    h = x @ p["w_up"]
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_down"]


def normal_init(shape, std: float, dtype, generator, *, stacked: int = 0):
    """N(0, std^2) drawn in fp32 and cast to ``dtype``, as ``jax.random.normal``
    then ``astype`` (``common.py:62-76``).  With ``stacked = n`` the result
    is ``(n, *shape)``, drawn one slice at a time so a stacked bf16 leaf
    never exists whole in fp32."""
    device = generator.device

    def draw():
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (t * std).to(dtype)

    if not stacked:
        return draw()
    out = torch.empty((stacked, *shape), dtype=dtype, device=device)
    for i in range(stacked):
        out[i] = draw()
    return out


def mlp_init(d: int, ff: int, mlp_type: str, dtype, generator,
             stacked: int = 0) -> dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {"w_up": normal_init((d, ff), s_in, dtype, generator, stacked=stacked),
         "w_down": normal_init((ff, d), s_out, dtype, generator,
                               stacked=stacked)}
    if mlp_type == "swiglu":
        p["w_gate"] = normal_init((d, ff), s_in, dtype, generator,
                                  stacked=stacked)
    return p


def dense_init(d_in: int, d_out: int, dtype, generator, stacked: int = 0):
    return normal_init((d_in, d_out), 1.0 / math.sqrt(d_in), dtype, generator,
                       stacked=stacked)
