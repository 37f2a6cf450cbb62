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
from repro_torch.kernels import ops
from repro_torch.tree import subtree  # noqa: F401  (re-exported)


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm in fp32, through the kernel dispatch (``kernels/ops.py``)."""
    return ops.rmsnorm(x, w, eps)


def rmsnorm_sharded(x, w, axis, eps: float = 1e-6):
    """RMSNorm with the FEATURE dim sharded over ``axis`` (the explicit-TP
    residual layout): the mean of squares is assembled in fp32 with the
    paper's sum-reduce R over ``axis``; w is the matching local shard.
    Call inside a ``dist_jit`` region.

    The sum is ``all_reduce``: inside a region a replicated result's
    cotangent is a per-rank contribution (``core/compile.py``), and the
    reference's ``sum_reduce`` is psum both ways
    (``repro/core/primitives.py:107-123``), which is the port's
    ``all_reduce``, not its explicit-copy ``sum_reduce``.  The plain
    kernel-free form, as in the reference: the kernel normalises whole rows.
    """
    xf = x.float()
    d = x.shape[-1] * prim.axis_size(axis)
    ss = prim.all_reduce((xf * xf).sum(-1, keepdim=True), axis)
    out = xf * torch.rsqrt(ss / d + eps)
    return (out * w.float()).to(x.dtype)


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
