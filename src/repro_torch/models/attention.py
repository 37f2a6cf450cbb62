"""GQA attention: flash kernel for train/prefill, cached for decode
(mirrors ``repro/models/attention.py``).

Train and prefill attention go through ``kernels.ops.flash_attention``:
the hand-written CUDA kernel on the card, its plain version on the host,
and in train mode a backward that recomputes through ``blockwise_attention``
(the JAX package's XLA online-softmax path, in ``kernels/ref.py`` and
re-exported here).  The one exception is training over a live ctx axis,
where the sequence is sharded and attention rings over it
(``core/ring_attention.py``, plain torch as in the reference, which
refuses its flash kernel under ctx).  Decode is a single-token
contraction against the KV cache in plain PyTorch, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import layers as L
from repro_torch.core.ring_attention import (ring_attention,
                                             ring_attention_region)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import blockwise_attention  # noqa: F401  (re-exported)

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
                    index: int = 0, cache_len=None, ctx_axis=None,
                    policy=None):
    """Full attention sub-layer: qkv proj -> rope -> attend -> out proj.

    x: (B, S, d).  Returns (out, kv) where kv is ``{"k", "v"}`` of this
    call's keys and values in prefill, and None in train and decode.
    Decode writes the new token's K/V into
    ``cache["k"][index]`` / ``cache["v"][index]`` (the slice of the stacked
    cache this superblock owns) IN PLACE, where the reference returns an
    updated copy, and attends over the first ``cache_len + 1`` positions.
    ``ctx_axis``: the caller sits in a region with that live ctx axis (the
    pipeline stage body), x is this rank's sequence shard and
    ``positions`` are global; train mode then rings over the axis.  A
    ``policy`` with a live ctx axis (x global, the same on every rank)
    makes train mode ring in one region over the policy's mesh
    (``ring_attention_region``), as the reference's GSPMD dispatch does.
    """
    hd = cfg.resolved_head_dim
    q = _split_heads(x @ p["wq"], cfg.num_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.num_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.num_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    kv = None
    if ctx_axis is not None and mode == "train":
        out = ring_attention(q, k, v, ctx_axis, chunk=cfg.attn_chunk)
    elif (policy is not None and policy.active_ctx_axis is not None
          and mode == "train"):
        out = ring_attention_region(q, k, v, policy, chunk=cfg.attn_chunk)
    elif mode in ("train", "prefill"):
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


def attention_block_tp(p, h, cfg, policy, *, positions):
    """Explicit-TP attention sub-layer on LOCAL blocks (inside dist_jit).

    h: (B_loc, S, d_model/tp): the residual stream is FEATURE-sharded over
    the model axis, so the qkv projections are gather-affines (the paper's
    partitioned broadcast B fused with the GEMM as a ring matmul under
    ``policy.explicit_tp``) and the output projection is a scatter-affine
    (the GEMM fused with the adjoint reduce-scatter R).  Heads stay sharded
    in between, so attention is head-local: ``ops.flash_attention`` on this
    rank's heads, the hand-written kernel on the card and the plain version
    on the host, as in ``attention_block``.  The reference attends with
    ``blockwise_attention`` here; the two agree at Sq == Skv (the flash
    kernel's top-left causal mask), which train mode always has.  Under a
    live ctx axis S is this rank's sequence shard and attention rings over
    it (``core/ring_attention.py``): ``positions`` must then be global.
    Train/prefill math only (no cache plumbing).
    """
    ax = policy.model_axis
    tp = policy.model_size
    hd = cfg.resolved_head_dim
    q = _split_heads(L.affine_gather(h, p["wq"], axis=ax),
                     cfg.num_heads // tp, hd)
    k = _split_heads(L.affine_gather(h, p["wk"], axis=ax),
                     cfg.num_kv_heads // tp, hd)
    v = _split_heads(L.affine_gather(h, p["wv"], axis=ax),
                     cfg.num_kv_heads // tp, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ctx = policy.active_ctx_axis
    if ctx is not None:
        out = ring_attention(q, k, v, ctx, chunk=cfg.attn_chunk)
    else:
        out = ops.flash_attention(q, k, v, causal=True)
    out = out.reshape(out.shape[0], out.shape[1], (cfg.num_heads // tp) * hd)
    return L.affine_scatter(out, p["wo"], axis=ax)
