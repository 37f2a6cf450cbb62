"""The tensor-core kernels' arithmetic, emulated on the host, against the
JAX package's oracles (``repro.kernels.ref``).

The bf16 routes of ``csrc/flash_attention_tc.cu`` and ``csrc/ssd_scan_tc.cu``
and the fp32 routes of ``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu``
(``tf32x3``) run only on the card.  What they round, and where, is pinned
here in plain torch at small shapes, so the precision design is checked
without a card.  The bf16 routes:

- flash: S = Q K^T accumulated in fp32 from bf16 q and k, the online
  softmax in fp32 over 64-column KV tiles, P rounded to bf16 for O += P V
  (fp32 accumulation), the row sum l from the fp32 P;
- SSD: G = C B^T in fp32 from bf16 C and B; W = mask(G exp(segsum) dt)
  formed in fp32 and split into a bf16 hi + lo pair; the carried state
  split the same way for C h^T; the scaled B (B dt exp(a_L - cumsum)) split
  into hi + lo for the state product, which accumulates in fp32.  (Rounding
  the state once to bf16 holds the pins at these shapes but not at
  mamba2-370m's serving shape, where it put 10 of 33.5M elements of y
  outside the bf16 pin on the card; the emulation agrees.)

The fp32 routes split every operand of every product into TF32 hi + lo
(10 mantissa bits, rounded to nearest with ties away from zero; the rest
rounded the same way) and sum lo*hi + hi*lo + hi*hi in fp32 (3xTF32):

- flash: q, k for S = Q K^T, P (fp32) and v for O += P V, over 64-column
  KV tiles, the softmax in fp32;
- SSD: C and B for G = C B^T; W (fp32) and x for W x; C and the fp32
  state copy for C h^T; the scaled B and x for the state product.

One TF32 pass (hi*hi only) misses the fp32 attention pin by far, which is
why the split is there.

Inputs are numpy draws from a seed.  Tolerances are the reference's pins
(``tests/test_kernels.py``): attention 2e-2 in bf16 and 2e-5 in fp32; the
SSD scan 5e-2 on y in bf16, 1e-4 in fp32, and 1e-4 on the final state,
which both sides form in fp32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

BN = 64   # the flash kernel's KV tile


def _bf(t):
    """Round to bf16 (nearest even) and back to fp32."""
    return t.to(torch.bfloat16).float()


def flash_tc_emulated(q, k, v, causal):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) bf16 -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)                          # (B, H, Sq, hd)
    kf = k.float().repeat_interleave(H // KH, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(H // KH, 2).transpose(1, 2)
    m = torch.full((B, H, Sq, 1), -1e30)
    lsum = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, BN):
        s = qf @ kf[:, :, k0:k0 + BN].transpose(-1, -2)
        cols = torch.arange(k0, min(k0 + BN, Skv))[None, :]
        if causal:
            s = torch.where(rows >= cols, s * scale, torch.full_like(s, -1e30))
        else:
            s = s * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf(p) @ vf[:, :, k0:k0 + BN]
        m = m_new
    o = acc / torch.clamp(lsum, min=1e-30)
    return o.transpose(1, 2).to(torch.bfloat16)


def ssd_tc_emulated(x, dt, a_neg, Bm, Cm, chunk, split_w=True):
    """x: (B,S,H,P) bf16; dt: (B,S,H); a_neg: (H,); Bm/Cm: (B,S,N) bf16
    -> (y (B,S,H,P) bf16, h_final (B,H,P,N) fp32).  ``split_w=False``
    rounds W once instead of splitting it."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = -S % L     # the ragged tail: dt = 0 steps, zero inputs
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    hT = torch.zeros((Bb, H, N, P))          # the state, rows n, in fp32
    ys = []
    for t0 in range(0, S + pad, L):
        xc, dtc = xf[:, t0:t0 + L], dtf[:, t0:t0 + L]
        bc, cc = bf[:, t0:t0 + L], cf[:, t0:t0 + L]
        acum = torch.cumsum(dtc * a_neg, dim=1)                  # (B, L, H)
        g = cc @ bc.transpose(-1, -2)                             # (B, L, L)
        seg = acum[:, :, None, :] - acum[:, None, :, :]
        seg = torch.where(causal[None, :, :, None], seg,
                          torch.full_like(seg, -math.inf))
        w = g[..., None] * torch.exp(seg) * dtc[:, None, :, :]    # b l m h
        w_hi = _bf(w)
        y = torch.einsum("blmh,bmhp->blhp", w_hi, xc)
        if split_w:
            y = y + torch.einsum("blmh,bmhp->blhp", _bf(w - w_hi), xc)
        h_hi = _bf(hT)
        y_inter = (torch.einsum("bln,bhnp->blhp", cc, h_hi)
                   + torch.einsum("bln,bhnp->blhp", cc, _bf(hT - h_hi)))
        y = y + y_inter * torch.exp(acum)[..., None]
        a_end = acum[:, -1]                                       # (B, H)
        f = dtc * torch.exp(a_end[:, None] - acum)                # (B, L, H)
        sb = bc[:, :, None, :] * f[..., None]                     # b l h n
        sb_hi = _bf(sb)
        sb_lo = _bf(sb - sb_hi)
        hT = (hT * torch.exp(a_end)[:, :, None, None]
              + torch.einsum("blhn,blhp->bhnp", sb_hi, xc)
              + torch.einsum("blhn,blhp->bhnp", sb_lo, xc))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(torch.bfloat16), hT.transpose(-1, -2).contiguous()


def _bf16_pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(a).astype(jnp.bfloat16), t


def _np(t):
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,H,KH", [
    (1, 128, 128, 4, 2),
    (2, 200, 200, 4, 1),     # a ragged last q tile and KV tile
])
def test_flash_emulation_holds_the_bf16_pin(hd, causal, B, Sq, Skv, H, KH):
    rng = np.random.default_rng(hd + Sq + causal)
    qj, qt = _bf16_pair(rng, (B, Sq, H, hd))
    kj, kt = _bf16_pair(rng, (B, Skv, KH, hd))
    vj, vt = _bf16_pair(rng, (B, Skv, KH, hd))
    got = flash_tc_emulated(qt, kt, vt, causal)
    want = jref.attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=2e-2, rtol=2e-2)


def test_flash_emulation_sq_ne_skv_non_causal():
    """Non-causal attention of 72 queries over 200 keys (two KV tiles, the
    last ragged)."""
    rng = np.random.default_rng(7)
    qj, qt = _bf16_pair(rng, (2, 72, 4, 64))
    kj, kt = _bf16_pair(rng, (2, 200, 2, 64))
    vj, vt = _bf16_pair(rng, (2, 200, 2, 64))
    got = flash_tc_emulated(qt, kt, vt, False)
    want = jref.attention_ref(qj, kj, vj, causal=False)
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               atol=2e-2, rtol=2e-2)


def _ssd_inputs(B, S, H, P, N, seed, model):
    """bf16 x, B, C and fp32 dt, a_neg, as the reference's sweep draws them
    or, with ``model``, as mamba2's block makes dt and A."""
    rng = np.random.default_rng(seed)
    xj, xt = _bf16_pair(rng, (B, S, H, P))
    bj, bt = _bf16_pair(rng, (B, S, N))
    cj, ct = _bf16_pair(rng, (B, S, N))
    z = rng.standard_normal((B, S, H)).astype(np.float32)
    dt = np.log1p(np.exp(z)).astype(np.float32)
    if model:
        a_neg = -np.exp(rng.uniform(0, math.log(16.0), H)).astype(np.float32)
    else:
        dt = dt * np.float32(0.1)
        a_neg = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.2)
    jax_args = (xj, jnp.asarray(dt), jnp.asarray(a_neg), bj, cj)
    torch_args = (xt, torch.from_numpy(dt), torch.from_numpy(a_neg), bt, ct)
    return jax_args, torch_args


@pytest.mark.parametrize("B,S,H,P,N,chunk,model", [
    (1, 128, 2, 16, 16, 32, False),    # the sweep of tests/test_kernels.py
    (2, 256, 4, 64, 32, 64, False),
    (1, 64, 1, 32, 128, 16, False),
    (1, 128, 8, 64, 64, 128, False),
    (2, 77, 8, 16, 16, 64, False),     # ragged
    (2, 200, 32, 64, 128, 64, True),   # mamba2-370m heads at its draws
])
def test_ssd_emulation_holds_the_pins(B, S, H, P, N, chunk, model):
    jax_args, torch_args = _ssd_inputs(B, S, H, P, N, S + H, model)
    y, h = ssd_tc_emulated(*torch_args, chunk=chunk)
    want_y, want_h = jref.ssd_ref(*jax_args)
    np.testing.assert_allclose(y.float().numpy(), _np(want_y),
                               atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(h.numpy(), _np(want_h), atol=1e-4, rtol=1e-4)


def test_ssd_single_rounding_of_w_breaks_the_bf16_pin():
    """Why W is split into hi + lo: at mamba2's draws, rounding the fp32 W
    once to bf16 puts y outside 5e-2 + 5e-2 |y| where |y| is small, since
    the error scales with the terms (|W x| ~ 10-100), not with y."""
    jax_args, torch_args = _ssd_inputs(2, 200, 32, 64, 128, 232, True)
    want_y = _np(jref.ssd_ref(*jax_args)[0])
    y = ssd_tc_emulated(*torch_args, chunk=64, split_w=False)[0]
    err = np.abs(y.float().numpy() - want_y)
    assert (err > 5e-2 + 5e-2 * np.abs(want_y)).any()


# ---- the fp32 routes: 3xTF32 ---------------------------------------------

def _tf32(t):
    """Round fp32 to TF32 (the low 13 mantissa bits cleared), to nearest
    with ties away from zero: the kernels' ``tf32_rna``."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, passes=3):
    """a @ b from TF32 hi + lo splits of both operands, summed in fp32:
    lo*hi + hi*lo + hi*hi (``passes=1``: hi*hi alone, one TF32 pass)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def flash_tf32x3_emulated(q, k, v, causal, passes=3):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) fp32 -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = q.transpose(1, 2)                                   # (B, H, Sq, hd)
    kf = k.repeat_interleave(H // KH, 2).transpose(1, 2)
    vf = v.repeat_interleave(H // KH, 2).transpose(1, 2)
    m = torch.full((B, H, Sq, 1), -1e30)
    lsum = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, BN):
        s = _mm3(qf, kf[:, :, k0:k0 + BN].transpose(-1, -2), passes)
        cols = torch.arange(k0, min(k0 + BN, Skv))[None, :]
        s = torch.where(rows >= cols, s * scale, torch.full_like(s, -1e30)) \
            if causal else s * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _mm3(p, vf[:, :, k0:k0 + BN], passes)
        m = m_new
    o = acc / torch.clamp(lsum, min=1e-30)
    return o.transpose(1, 2).contiguous()


def ssd_tf32x3_emulated(x, dt, a_neg, Bm, Cm, chunk):
    """x: (B,S,H,P); dt: (B,S,H); a_neg: (H,); Bm/Cm: (B,S,N), all fp32
    -> (y (B,S,H,P), h_final (B,H,P,N))."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = -S % L     # the ragged tail: dt = 0 steps, zero inputs
    xf = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    bf = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
    cf = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    hT = torch.zeros((Bb, H, N, P))          # the state, rows n, in fp32
    ys = []
    for t0 in range(0, S + pad, L):
        xc = xf[:, t0:t0 + L].permute(0, 2, 1, 3)                 # b h l p
        dtc = dtf[:, t0:t0 + L]
        bc, cc = bf[:, t0:t0 + L], cf[:, t0:t0 + L]
        acum = torch.cumsum(dtc * a_neg, dim=1)                  # (B, L, H)
        g = _mm3(cc, bc.transpose(-1, -2))                        # (B, L, L)
        seg = acum[:, :, None, :] - acum[:, None, :, :]
        seg = torch.where(causal[None, :, :, None], seg,
                          torch.full_like(seg, -math.inf))
        w = (g[..., None] * torch.exp(seg)
             * dtc[:, None, :, :]).permute(0, 3, 1, 2)            # b h l m
        y = _mm3(w, xc)                                           # b h l p
        y_inter = _mm3(cc[:, None], hT)                           # b h l p
        y = y + y_inter * torch.exp(acum).permute(0, 2, 1)[..., None]
        a_end = acum[:, -1]                                       # (B, H)
        f = dtc * torch.exp(a_end[:, None] - acum)                # (B, L, H)
        sb = (bc[:, :, None, :] * f[..., None]).permute(0, 2, 3, 1)  # b h n l
        hT = hT * torch.exp(a_end)[:, :, None, None] + _mm3(sb, xc)
        ys.append(y.permute(0, 2, 1, 3))
    y = torch.cat(ys, dim=1)[:, :S]
    return y, hT.transpose(-1, -2).contiguous()


def _f32_pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_tf32_rounding_is_nearest_ties_away():
    """Ties (the 13 dropped bits exactly 0x1000) round away from zero."""
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    got = _tf32(torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2 ** -23),
                           one * (1 + ulp / 4)]))
    assert got.tolist() == [1 + ulp, -(1 + ulp), 1.0, -1.0, 1.0, -1.0]


@pytest.mark.parametrize("hd", [16, 64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,H,KH", [
    (1, 128, 128, 4, 2),     # GQA
    (2, 200, 200, 4, 1),     # MQA, a ragged last q tile and KV tile
])
def test_flash_tf32x3_emulation_holds_the_fp32_pin(hd, causal, B, Sq, Skv,
                                                   H, KH):
    rng = np.random.default_rng(hd + Sq + causal)
    qj, qt = _f32_pair(rng, (B, Sq, H, hd))
    kj, kt = _f32_pair(rng, (B, Skv, KH, hd))
    vj, vt = _f32_pair(rng, (B, Skv, KH, hd))
    got = flash_tf32x3_emulated(qt, kt, vt, causal)
    want = jref.attention_ref(qj, kj, vj, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_tf32x3_emulation_sq_ne_skv_non_causal():
    rng = np.random.default_rng(8)
    qj, qt = _f32_pair(rng, (2, 72, 4, 64))
    kj, kt = _f32_pair(rng, (2, 200, 2, 64))
    vj, vt = _f32_pair(rng, (2, 200, 2, 64))
    got = flash_tf32x3_emulated(qt, kt, vt, False)
    want = jref.attention_ref(qj, kj, vj, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_one_tf32_pass_breaks_the_fp32_attention_pin():
    """Why every operand is split: one TF32 pass (10 mantissa bits) puts
    causal attention far outside 2e-5 + 2e-5 |o|."""
    rng = np.random.default_rng(11)
    qj, qt = _f32_pair(rng, (1, 256, 4, 128))
    kj, kt = _f32_pair(rng, (1, 256, 4, 128))
    vj, vt = _f32_pair(rng, (1, 256, 4, 128))
    want = np.asarray(jref.attention_ref(qj, kj, vj, causal=True))
    err = np.abs(flash_tf32x3_emulated(qt, kt, vt, True, passes=1).numpy()
                 - want)
    assert (err > 2e-5 + 2e-5 * np.abs(want)).mean() > 0.1
    three = flash_tf32x3_emulated(qt, kt, vt, True).numpy()
    np.testing.assert_allclose(three, want, atol=2e-5, rtol=2e-5)


def _ssd_f32_inputs(B, S, H, P, N, seed):
    """fp32 x, B, C, dt, a_neg as the reference's sweep draws them."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((B, S, H, P), (B, S, N), (B, S, N))]
    z = rng.standard_normal((B, S, H)).astype(np.float32)
    dt = (np.log1p(np.exp(z)) * np.float32(0.1)).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal(H).astype(np.float32) * 0.2)
    arrays = (xs[0], dt, a_neg.astype(np.float32), xs[1], xs[2])
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 16, 16, 32),      # the sweep of tests/test_kernels.py
    (2, 256, 4, 64, 32, 64),
    (1, 64, 1, 32, 128, 16),
    (1, 128, 8, 64, 64, 128),
    (2, 77, 8, 16, 16, 64),       # a ragged last chunk
    (2, 40, 8, 64, 128, 64),      # a prompt shorter than one chunk
])
def test_ssd_tf32x3_emulation_holds_the_fp32_pins(B, S, H, P, N, chunk):
    jax_args, torch_args = _ssd_f32_inputs(B, S, H, P, N, S + H + P)
    y, h = ssd_tf32x3_emulated(*torch_args, chunk=chunk)
    want_y, want_h = jref.ssd_ref(*jax_args)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
