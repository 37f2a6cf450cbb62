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

from repro_torch.kernels import ops


def subtree(params: dict, prefix: str) -> dict:
    """The entries of ``params`` under ``prefix.``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def rmsnorm(x, w, eps: float = 1e-6):
    """RMSNorm in fp32, through the kernel dispatch (``kernels/ops.py``)."""
    return ops.rmsnorm(x, w, eps)


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
