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


def ssd_ref(x, dt, a_neg, Bm, Cm, h0=None):
    """Naive per-step SSD recurrence (``repro/kernels/ref.py:28-52``).

    x: (B,S,H,P); dt: (B,S,H); a_neg: (H,); Bm/Cm: (B,S,N).
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t
    fp32 inside; returns (y in x's dtype, the final state (B,H,P,N) fp32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * a_neg[None, :])
        h = h * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def rmsnorm_ref(x, w, eps=1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w over the last dim, fp32 inside."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
