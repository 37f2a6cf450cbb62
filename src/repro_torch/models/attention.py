"""GQA attention: flash kernel for train/prefill, cached for decode
(mirrors ``repro/models/attention.py``).

Train and prefill attention always go through ``kernels.ops.flash_attention``:
the hand-written CUDA kernel on the card, its plain version on the host.
``blockwise_attention`` (the JAX package's XLA online-softmax path) stays as
a second plain reference for the tests.  Decode is a single-token
contraction against the KV cache in plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

from .common import apply_rope, dense_init

NEG_INF = -1e30


def attn_init(cfg, dtype, generator, stacked: int = 0) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(d, cfg.num_heads * hd, dtype, generator, stacked),
        "wk": dense_init(d, cfg.num_kv_heads * hd, dtype, generator, stacked),
        "wv": dense_init(d, cfg.num_kv_heads * hd, dtype, generator, stacked),
        "wo": dense_init(cfg.num_heads * hd, d, dtype, generator, stacked),
    }


def _split_heads(x, n_heads, hd):
    return x.reshape(x.shape[:-1] + (n_heads, hd))


def blockwise_attention(q, k, v, *, chunk: int, causal: bool = True):
    """Online-softmax attention over KV chunks (the JAX model's XLA path).

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd) with H % KH == 0.
    Returns (B, Sq, H, hd).  fp32 accumulation; p is cast to q's dtype
    before the PV product, as in the reference.
    """
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
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


def decode_attention(q, k_cache, v_cache, cache_len: int):
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S_max, KH, hd); positions at or beyond
    ``cache_len`` are masked.  Scores in fp32, as with the reference's
    ``preferred_element_type``.
    """
    B, _, H, hd = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    group = H // KH
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KH, group, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    valid = torch.arange(S, device=q.device) < cache_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attention_block(p, x, cfg, *, positions, mode, cache=None,
                    index: int = 0, cache_len=None):
    """Full attention sub-layer: qkv proj -> rope -> attend -> out proj.

    x: (B, S, d).  Returns (out, kv) where kv is ``{"k", "v"}`` of this
    call's keys and values in prefill, and None in train and decode.
    Decode writes the new token's K/V into
    ``cache["k"][index]`` / ``cache["v"][index]`` (the slice of the stacked
    cache this superblock owns) IN PLACE, where the reference returns an
    updated copy, and attends over the first ``cache_len + 1`` positions.
    """
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kv = None
    if mode in ("train", "prefill"):
        out = ops.flash_attention(q, k, v, causal=True)
        if mode == "prefill":
            kv = {"k": k, "v": v}
    else:  # decode
        k_cache, v_cache = cache["k"][index], cache["v"][index]
        k_cache[:, cache_len] = k[:, 0]
        v_cache[:, cache_len] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, cache_len + 1)

    out = out.reshape(out.shape[0], out.shape[1], cfg.num_heads * hd)
    return out @ p["wo"], kv
