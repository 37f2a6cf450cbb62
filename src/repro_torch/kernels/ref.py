"""Plain PyTorch versions of the kernels (mirrors ``repro/kernels/ref.py``).

Each is the slow, obviously correct function its kernel must match: the
CPU path of ``ops`` and the yardstick of correctness ``chip_smoke.py``
holds each kernel against on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True):
    """Naive attention.  q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd).

    fp32 internally, output in q's dtype.  The causal mask is the flash
    kernel's top-left ``rows >= cols`` (``flash_attention.py:50-53``); it
    equals the reference's bottom-right ``tril`` when Sq == Skv.
    """
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    group = H // KH
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, Sq, KH, group, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * scale
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w over the last dim, fp32 inside."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
