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

Under a serve policy (``attention_block_tp`` in prefill and decode, every
rank holding its own heads) the cache is sharded by ``policy.kv_layout``
over the model axis, as the reference's GSPMD places it
(``repro/models/attention.py:200-212,247-254``): ``kvdim`` splits head_dim,
so decode's score contraction sums partials over the axis; ``kvseq``
splits the sequence into one contiguous block a rank, and decode is
flash-decoding: each rank attends over its own block and the (max, sum,
output) partials are combined by a max all-reduce and a sum all-reduce.
The heads-to-layout moves are the port's ``Repartition``.  Where the
model axis does not divide the K/V heads (glm4-9b's 2 under TP 4), ``wk``
and ``wv`` stay whole on every rank, as the reference's ``param_spec``
leaves them (``repro/sharding/policy.py:296``): each rank computes every
K/V head, attends its query heads with the K/V heads their groups map to,
and keeps its part of every K/V head in the cache (``kvdim``: its
head_dim columns; ``kvseq``: its sequence block), so only q moves.
Where the model axis does not divide the query heads (40 over 16), they
split by the paper's ceil-first balanced decomposition (``head_block``:
ranks 0-7 hold 3 heads, 8-15 hold 2), the same in serving and in the
policy train program; the K/V heads are then whole as well, and q moves
by the primitives' collectives of unequal blocks.  Under ``kvdim`` a
head_dim the model axis does not divide (glm4-9b's 128 over 3) splits the
same way: 43, 43 and 42 columns of every K/V head a rank.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import layers as L
from repro_torch.core import primitives as prim
from repro_torch.core.linop import Layout, Repartition
from repro_torch.core.partition import balanced_split, shard_offsets
from repro_torch.core.ring_attention import (ring_attention,
                                             ring_attention_region)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import blockwise_attention  # noqa: F401  (re-exported)

from .common import (apply_rope, dense_init, gather_block, seq_gather,
                     seq_scatter)

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


def attention_block_tp(p, h, cfg, policy, *, positions, mode="train",
                       cache=None, index: int = 0, cache_len=None):
    """Explicit-TP attention sub-layer on LOCAL blocks (inside a region).

    h: (B_loc, S, d_loc): the residual stream is FEATURE-sharded over the
    model axis (the balanced split of d_model where the axis does not
    divide it), so the qkv projections are gather-affines (the paper's
    partitioned broadcast B fused with the GEMM as a ring matmul under
    ``policy.explicit_tp``) and the output projection is a scatter-affine
    (the GEMM fused with the adjoint reduce-scatter R).  Heads stay sharded
    in between, so attention is head-local: ``ops.flash_attention`` on this
    rank's heads, the hand-written kernel on the card and the plain version
    on the host, as in ``attention_block``.  The reference attends with
    ``blockwise_attention`` here; the two agree at Sq == Skv (the flash
    kernel's top-left causal mask), which train and prefill always have.
    Under a live ctx axis (train) S is this rank's sequence shard and
    attention rings over it (``core/ring_attention.py``): ``positions``
    must then be global.  The query heads split by the balanced
    decomposition (``local_heads``): where the model axis does not divide
    them, the first ranks hold one head more.

    Serving (``mode`` prefill or decode; the weights are this rank's
    shards, ``cache`` this rank's part of ``models.init_cache(...,
    policy=)``): prefill writes each layer's K/V into ``cache[..][index]``
    in the ``policy.kv_layout`` layout; decode writes the new token's K/V
    where that layout keeps position ``cache_len`` and attends over the
    first ``cache_len + 1`` positions (module docstring).
    """
    ax = policy.model_axis
    tp = policy.model_size
    hd = cfg.resolved_head_dim
    kv_whole = cfg.num_kv_heads % tp != 0
    kh = cfg.num_kv_heads if kv_whole else cfg.num_kv_heads // tp
    _, n = local_heads(cfg, policy)
    q = _split_heads(L.affine_gather(h, p["wq"], axis=ax), n, hd)
    k = _split_heads(L.affine_gather(h, p["wk"], axis=ax), kh, hd)
    v = _split_heads(L.affine_gather(h, p["wv"], axis=ax), kh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ctx = policy.active_ctx_axis
    if mode == "decode":
        out = _decode_tp(q, k, v, cache, index, cache_len, cfg, policy,
                         kv_whole)
    else:
        kl, vl = ((_kv_of_local_heads(t, cfg, policy) for t in (k, v))
                  if kv_whole else (k, v))
        if ctx is not None and mode == "train":
            out = ring_attention(q, kl, vl, ctx, chunk=cfg.attn_chunk)
        else:
            out = ops.flash_attention(q, kl, vl, causal=True)
        if mode == "prefill":
            _prefill_cache_tp(k, v, cache, index, policy, kv_whole)
    out = out.reshape(out.shape[0], out.shape[1], n * hd)
    return L.affine_scatter(out, p["wo"], axis=ax)


def attention_block_sp(p, specs, h, cfg, policy, *, positions, fsdp_axes):
    """The attention sub-layer of the policy train program on this rank
    (``models.forward`` under a policy with ``seq_shard``).

    h: (B/dp, S_loc, d), the normed residual's sequence shard; ``p``: this
    rank's blocks of wq, wk, wv, wo laid out by ``specs`` (ZeRO-3 over the
    fsdp axes, heads over ``model``).  The sequence is gathered, each
    weight gathered over the fsdp axes right before its use, q on this
    rank's query heads (``local_heads``); attention runs on them through
    ``ops.flash_attention`` (whole sequence, causal), and wo's row block
    reduce-scatters the partial output back onto the sequence shard.
    Where ``model`` does not divide the K/V heads (glm4-9b's 2 under TP 4)
    wk and wv are gathered whole over ``model`` as well and each rank
    takes the K/V heads its query heads attend (``_kv_of_local_heads``);
    where it does not divide the query heads, so do wq and wo, and each
    rank takes its balanced block of heads: wq's columns and wo's rows.
    Their gradients return to the blocks through the gather's adjoint (or,
    for a leaf the spec leaves whole, the sum over ``model`` after the
    backward), each rank contributing zero to the other ranks' heads.
    ``positions``: (B/dp, S), global."""
    ax = policy.model_axis
    tp = policy.model_size
    hd = cfg.resolved_head_dim
    kv_whole = cfg.num_kv_heads % tp != 0
    q_whole = cfg.num_heads % tp != 0
    kv_axes = fsdp_axes + ((ax,) if kv_whole else ())
    q_axes = fsdp_axes + ((ax,) if q_whole else ())
    first, n = local_heads(cfg, policy)
    x = seq_gather(h, ax, positions.shape[1])
    wq = gather_block(p["wq"], specs["wq"], q_axes)
    if q_whole:
        wq = wq[:, first * hd:(first + n) * hd]
    q = _split_heads(x @ wq, n, hd)
    kh = cfg.num_kv_heads if kv_whole else cfg.num_kv_heads // tp
    k = _split_heads(x @ gather_block(p["wk"], specs["wk"], kv_axes), kh, hd)
    v = _split_heads(x @ gather_block(p["wv"], specs["wv"], kv_axes), kh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_whole:
        k, v = (_kv_of_local_heads(t, cfg, policy) for t in (k, v))
    out = ops.flash_attention(q, k, v, causal=True)
    out = out.reshape(out.shape[0], out.shape[1], n * hd)
    wo = gather_block(p["wo"], specs["wo"], q_axes)
    if q_whole:
        wo = wo[first * hd:(first + n) * hd]
    return seq_scatter(out @ wo, ax, tp > 1)


def head_block(num_heads: int, tp: int, index: int) -> tuple[int, int]:
    """(first, count) of the query heads that rank ``index`` of a
    ``tp``-way model axis holds: the paper's ceil-first balanced split
    (``core/partition.py``), so 40 heads over 16 ranks give ranks 0-7
    three heads and ranks 8-15 two.  Every site that splits heads over
    ``model`` uses it."""
    return (shard_offsets(num_heads, tp)[index],
            balanced_split(num_heads, tp)[index])


def local_heads(cfg, policy) -> tuple[int, int]:
    """``head_block`` of this rank along ``policy``'s model axis."""
    return head_block(cfg.num_heads, policy.model_size,
                      prim.axis_index(policy.model_axis))


def local_kv_heads(cfg, tp: int, index: int) -> list[int]:
    """The K/V heads that rank ``index``'s query heads attend, laid out for
    the GQA grouping of ``ops.flash_attention`` (query head j of n attends
    K/V head j // (n / kv)): where the rank holds whole groups, their K/V
    heads; where its heads lie in one group, that group's head; otherwise
    (a rank holding parts of two groups, as phi3-medium's 40 heads over
    10 K/V heads at TP 16 give) one K/V head per query head; none for a
    rank that holds no query head (a model axis larger than the head
    count)."""
    first, n = head_block(cfg.num_heads, tp, index)
    if n == 0:
        return []
    group = cfg.num_heads // cfg.num_kv_heads
    lo, hi = first // group, (first + n - 1) // group
    if lo == hi:
        return [lo]
    if first % group == 0 and n % group == 0:
        return list(range(lo, hi + 1))
    return [(first + j) // group for j in range(n)]


def _kv_of_local_heads(t, cfg, policy):
    """Of every K/V head, (B, S, KH, hd), the ones this rank's query heads
    attend (``local_kv_heads``): a slice where they are consecutive, an
    empty one where the rank holds no query head."""
    idx = local_kv_heads(cfg, policy.model_size,
                         prim.axis_index(policy.model_axis))
    if not idx:
        return t[:, :, :0]
    if idx == list(range(idx[0], idx[-1] + 1)):
        return t[:, :, idx[0]:idx[-1] + 1]
    return t[:, :, torch.tensor(idx, device=t.device)]


def _heads_to(dim: int, policy) -> Repartition:
    """The move of a (B, S, heads, hd) block from the heads split over the
    model axis (dim 2) to the split of ``dim``."""
    ax = policy.model_axis
    return Repartition(Layout(ax, 2), Layout(ax, dim))


def _prefill_cache_tp(k, v, cache, index: int, policy, kv_whole=False):
    """The prompt's K/V into this rank's part of the cache: under ``kvdim``
    its block of the head_dim split (B, S, KH, hd_loc; the balanced split
    where the model axis does not divide head_dim) into the first S
    positions; under ``kvseq`` the sequence split of the whole (padded)
    buffer, (B, S_buf, KH, hd) a rank, zeros past the prompt.  k, v: this
    rank's heads, (B, S, KH/tp, hd), moved by an all-to-all (``kvdim``) or
    ``Repartition`` (``kvseq``); with ``kv_whole`` every K/V head, (B, S,
    KH, hd), of which the rank keeps its part."""
    ax, tp = policy.model_axis, policy.model_size
    me = prim.axis_index(ax)
    for name, t in (("k", k), ("v", v)):
        buf = cache[name][index]
        if policy.kv_layout == "kvdim":
            hd = t.shape[3]
            lo = shard_offsets(hd, tp)[me]
            buf[:, :t.shape[1]] = (
                t[..., lo:lo + buf.shape[3]] if kv_whole else
                prim.all_to_all_v(t, ax, 3, 2, balanced_split(hd, tp),
                                  [t.shape[2]] * tp))
        elif kv_whole:
            part = t[:, me * buf.shape[1]:(me + 1) * buf.shape[1]]
            buf.zero_()
            buf[:, :part.shape[1]] = part
        else:
            full = t.new_zeros((t.shape[0], buf.shape[1] * policy.model_size)
                               + t.shape[2:])
            full[:, :t.shape[1]] = t
            buf.copy_(_heads_to(1, policy)(full))


def _decode_tp(q, k, v, cache, index: int, cache_len: int, cfg, policy,
               kv_whole=False):
    """One token's attention, (B, 1, n, hd) -> (B, 1, n, hd), this rank's
    n query heads (``local_heads``) against the sharded cache (module
    docstring); k, v are this rank's K/V heads, or every K/V head with
    ``kv_whole``.  With ``kv_whole`` only q moves, by the collectives of
    unequal blocks where the model axis does not divide the query heads
    (it then does not divide the K/V heads either: H = group x KH):
    under ``kvdim`` an ``all_to_all_v`` to the head_dim split and back,
    under ``kvseq`` an ``all_gather_replicated_v``.  Scores, softmax and
    the p.v contraction in fp32, as ``decode_attention``.  Under ``kvdim``
    the head_dim blocks are the balanced split where the model axis does
    not divide head_dim (glm4-9b's 128 over 3: 43, 43, 42): the score
    all-reduce sums the blocks' partial dot products, whatever their
    widths."""
    ax = policy.model_axis
    tp = policy.model_size
    B, _, h_loc, hd = q.shape
    H = cfg.num_heads
    counts = balanced_split(H, tp)
    first, _ = local_heads(cfg, policy)
    kh_loc = k.shape[2]
    KH = kh_loc if kv_whole else kh_loc * tp
    group = H // KH
    scale = 1.0 / math.sqrt(hd)
    k_cache, v_cache = cache["k"][index], cache["v"][index]
    me = prim.axis_index(ax)
    if policy.kv_layout == "kvdim":
        d_sizes = balanced_split(hd, tp)
        d_loc, lo = d_sizes[me], shard_offsets(hd, tp)[me]
        if kv_whole:
            # only q moves: every rank holds every K/V head whole
            q = prim.all_to_all_v(q, ax, 3, 2, d_sizes, counts)
            q = q.reshape(B, H, d_loc)
            k, v = (t[..., lo:lo + d_loc].reshape(B, KH, d_loc)
                    for t in (k, v))
        else:
            # one all-to-all moves q, k and v to the head_dim split; the
            # blocks arrive rank-major, each rank's heads in global order
            moved = prim.all_to_all_v(torch.cat([q, k, v], dim=2), ax, 3, 2,
                                      d_sizes, [h_loc + 2 * kh_loc] * tp)
            moved = moved.reshape(B, 1, tp, -1, d_loc)
            q = moved[:, :, :, :h_loc].reshape(B, H, d_loc)
            k = moved[:, :, :, h_loc:h_loc + kh_loc].reshape(B, KH, d_loc)
            v = moved[:, :, :, h_loc + kh_loc:].reshape(B, KH, d_loc)
        k_cache[:, cache_len] = k
        v_cache[:, cache_len] = v
        qf = q.reshape(B, KH, group, d_loc).float()
        s = prim.all_reduce(torch.einsum("bkgh,bskh->bkgs", qf,
                                         k_cache.float()), ax) * scale
        S = k_cache.shape[1]
        valid = torch.arange(S, device=q.device) < cache_len + 1
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype).float(),
                         v_cache.float())
        o = o.reshape(B, 1, H, d_loc).to(q.dtype)
        return prim.all_to_all_v(o, ax, 2, 3, counts, d_sizes)
    # kvseq: q, k, v gathered whole; the owner of position cache_len
    # writes it; every rank attends over its own block (flash-decoding)
    if kv_whole:
        q = prim.all_gather_replicated_v(q, ax, 2, counts).reshape(B, H, hd)
        k, v = k.reshape(B, KH, hd), v.reshape(B, KH, hd)
    else:
        whole = prim.all_gather(torch.cat([q, k, v], dim=2), ax, 2)
        whole = whole.reshape(B, 1, tp, -1, hd)
        q = whole[:, :, :, :h_loc].reshape(B, H, hd)
        k = whole[:, :, :, h_loc:h_loc + kh_loc].reshape(B, KH, hd)
        v = whole[:, :, :, h_loc + kh_loc:].reshape(B, KH, hd)
    blk = k_cache.shape[1]
    if cache_len // blk == me:
        k_cache[:, cache_len % blk] = k
        v_cache[:, cache_len % blk] = v
    qf = q.reshape(B, KH, group, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k_cache.float()) * scale
    pos = me * blk + torch.arange(blk, device=q.device)
    s = torch.where(pos < cache_len + 1, s, torch.full_like(s, NEG_INF))
    m = prim.pmax(s.amax(dim=-1, keepdim=True), ax)
    p = torch.exp(s - m)
    part = torch.cat([torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype).float(),
                                   v_cache.float()),
                      p.sum(dim=-1, keepdim=True)], dim=-1)
    part = prim.all_reduce(part, ax)           # (B, KH, g, hd + 1)
    o = (part[..., :hd] / part[..., hd:]).reshape(B, 1, H, hd).to(q.dtype)
    return o[:, :, first:first + h_loc]
