"""Plain PyTorch versions of the kernels (mirrors ``repro/kernels/ref.py``).

Each is the slow, obviously correct function its kernel must match: the
CPU path of ``ops`` and the yardstick of correctness ``chip_smoke.py``
holds each kernel against on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True):
    """Naive attention.  q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd).

    fp32 internally, output in q's dtype.  The causal mask is the flash
    kernel's top-left ``rows >= cols`` (``flash_attention.py:50-53``); it
    equals the reference's bottom-right ``tril`` when Sq == Skv.  An empty
    head block (H = KH = 0) gives the empty (B, Sq, 0, hd), as the kernel.
    """
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if H == 0:
        return q.clone()
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


def blockwise_attention(q, k, v, *, chunk: int, causal: bool = True):
    """Online-softmax attention over KV chunks (the JAX model's XLA path).

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd) with H % KH == 0.
    Returns (B, Sq, H, hd).  fp32 accumulation; p is cast to q's dtype
    before the PV product, as in the reference.  An empty head block
    (H = KH = 0) gives the empty (B, Sq, 0, hd).
    """
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if H == 0:
        return q.clone()
    group = H // KH
    scale = 1.0 / math.sqrt(hd)
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    chunk = min(chunk, Skv)
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    for j in range(0, Skv, chunk):
        kc, vc = k[:, j:j + chunk], v[:, j:j + chunk]
        s = torch.einsum("bqhd,bchd->bqhc", q.float(), kc.float()) * scale
        kv_pos = j + torch.arange(kc.shape[1], device=q.device)
        if causal:
            mask = q_pos[:, None] >= kv_pos[None, :]          # (Sq, chunk)
            s = torch.where(mask[None, :, None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p.to(q.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


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


def ssd_chunked(x, dt, a_neg, Bm, Cm, *, chunk: int, h0=None):
    """Chunked SSD scan (``repro/models/ssm.py:68-127``), fp32 inside.

    x: (B, S, H, P); dt: (B, S, H) positive steps; a_neg: (H,) negative;
    Bm, Cm: (B, S, N) (one group); h0: optional (B, H, P, N) initial state.
    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32).
    """
    Bb, S, H, Pd = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if S % L:
        # ragged tail: pad with dt=0 steps -- decay exp(0)=1 and zero input
        # contribution make padding exact, not approximate.
        pad = L - S % L

        def pw(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        y, hT = ssd_chunked(pw(x), pw(dt), a_neg, pw(Bm), pw(Cm),
                            chunk=chunk, h0=h0)
        return y[:, :S], hT
    nc = S // L

    xf = x.float().reshape(Bb, nc, L, H, Pd)
    dtf = dt.float().reshape(Bb, nc, L, H)
    Bf = Bm.float().reshape(Bb, nc, L, N)
    Cf = Cm.float().reshape(Bb, nc, L, N)
    a = dtf * a_neg[None, None, None, :]                 # (B, nc, L, H) <= 0
    h = (torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        acum = torch.cumsum(a[:, c], dim=1)              # (B,L,H) inclusive
        # ---- intra-chunk (the "duality" quadratic form) ----
        seg = acum[:, :, None, :] - acum[:, None, :, :]  # (B,L,L,H): l,m
        # mask BEFORE exp: the anti-causal lanes have seg >> 0
        seg = torch.where(causal[None, :, :, None], seg,
                          torch.full_like(seg, -math.inf))
        w = torch.exp(seg)
        cb = torch.einsum("bln,bmn->blm", cc, bc)        # (B,L,L)
        wmat = cb[..., None] * w * dtc[:, None, :, :]    # (B,L,L,H)
        y_intra = torch.einsum("blmh,bmhp->blhp", wmat, xc)
        # ---- inter-chunk: contribution of the carried state ----
        y_inter = (torch.einsum("bln,bhpn->blhp", cc, h)
                   * torch.exp(acum)[..., None])
        # ---- state update ----
        decay_to_end = torch.exp(acum[:, -1:, :] - acum)  # (B,L,H)
        s_c = torch.einsum("bln,blh,blhp->bhpn", bc, dtc * decay_to_end, xc)
        h = h * torch.exp(acum[:, -1, :])[:, :, None, None] + s_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, Pd)
    return y.to(x.dtype), h


def rmsnorm_ref(x, w, eps=1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w over the last dim, fp32 inside."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
