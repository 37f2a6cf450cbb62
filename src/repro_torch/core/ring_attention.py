"""Ring attention: context parallelism as adjoint ring operators (mirrors
``repro/core/ring_attention.py``, DESIGN §6).

The score contraction wants every key and value against every query, but
the sequence stays sharded over the ``ctx`` mesh axis: rank r owns rows
``[r*S_loc, (r+1)*S_loc)`` of q, k and v.  Attention over the distributed
sequence decomposes into a ring of linear data-movement operators composed
with local online-softmax blocks:

- Each hop contracts the LOCAL q shard against the visiting KV shard
  (:func:`ring_hop`), merging the fp32 running stats ``(m, l, acc)``.
- Between hops the K/V shards rotate one position (``primitives.
  ring_shift``, the ``KVRingShift`` operator of ``linop.py``: a permutation
  whose adjoint is the reverse rotation).
- The backward is per-rank autograd through the hop math and the shift's
  hand-written reverse rotation, the structure JAX's AD composes.  Inside
  the pipeline executor the stage body holds the whole routine, so its
  recompute-at-saved-input backward replays the same ring in reverse.

Causal masking on global positions: at hop t rank r holds the shard that
started at ``src = (r - t) % cp``; the block is "full" (src < r), the
diagonal (src == r) or "skip" (src > r), and all three are the ONE
predicate ``q_pos >= kv_pos``.  Every rank runs the same hops and the same
shifts (NCCL needs the whole ctx group in every shift); a skip block is
computed and masked, never skipped (skipping it is later work).  The
diagonal block comes FIRST, so the running max is finite before a fully
masked block contributes ``exp(NEG_INF - m) == 0``.

Nothing here is a kernel: the reference rings in XLA-level jnp and refuses
its Pallas flash kernel under ctx, so the hop's products are plain torch
matrix products.  Call :func:`ring_attention` from per-rank code (a region
body, a pipeline stage) and :func:`ring_attention_region` with global
tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import primitives as prim

__all__ = [
    "NEG_INF",
    "attention_working_set_bytes",
    "check_attention_budget",
    "ring_attention",
    "ring_attention_region",
    "ring_finish",
    "ring_hop",
    "ring_init",
]

NEG_INF = -1e30


def ring_init(q):
    """The running stats ``(m, l, acc)`` before the first hop, fp32:
    m (B, Sq, H) at NEG_INF, l (B, Sq, H) and acc (B, Sq, H, hd) at 0."""
    B, Sq, H, hd = q.shape
    kw = {"dtype": torch.float32, "device": q.device}
    return (torch.full((B, Sq, H), NEG_INF, **kw), torch.zeros((B, Sq, H), **kw),
            torch.zeros((B, Sq, H, hd), **kw))


def ring_hop(carry, q, k_cur, v_cur, *, q_pos0: int, kv_base: int,
             chunk: int, causal: bool = True):
    """Online-softmax pass of local q over one visiting KV shard.

    carry: ``(m, l, acc)`` (see :func:`ring_init`).  q: (B, Sq, H, hd)
    whose rows sit at global positions ``q_pos0 + arange(Sq)``; k_cur,
    v_cur: (B, Skv, KH, hd) at global positions ``kv_base + arange(Skv)``,
    H % KH == 0.  The shard is walked in ``chunk``-sized blocks (the last
    one zero-padded and masked); scores and sums are fp32, and p is
    rounded to q's dtype before the P V product, as in the reference.
    Returns the merged carry.
    """
    m, l, acc = carry
    B, Sq, H, hd = q.shape
    Skv, KH = k_cur.shape[1], k_cur.shape[2]
    group = H // KH
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Skv)
    dev = q.device
    q_pos = q_pos0 + torch.arange(Sq, device=dev)
    qf = q.float()
    for j0 in range(0, Skv, chunk):
        kc, vc = k_cur[:, j0:j0 + chunk], v_cur[:, j0:j0 + chunk]
        pad = chunk - kc.shape[1]
        if pad:
            kc = F.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = F.pad(vc, (0, 0, 0, 0, 0, pad))
        if group > 1:
            kc = kc.repeat_interleave(group, dim=2)
            vc = vc.repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bchd->bqhc", qf, kc.float()) * scale
        lp = j0 + torch.arange(chunk, device=dev)
        mask = (lp < Skv)[None, :]                          # padding mask
        if causal:
            mask = mask & (q_pos[:, None] >= (kv_base + lp)[None, :])
        else:
            mask = mask.expand(Sq, chunk)
        s = torch.where(mask[None, :, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhc,bchd->bqhd", p.to(q.dtype).float(), vc.float())
        m = m_new
    return m, l, acc


def ring_finish(carry, dtype):
    """The attention output ``acc / max(l, 1e-30)`` in ``dtype``."""
    _, l, acc = carry
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def ring_attention(q, k, v, axis_name, *, chunk: int, causal: bool = True):
    """Blockwise online-softmax attention over sequence shards on a ring.

    Per-rank code (inside a region with ``axis_name`` on the current
    mesh).  q: (B, Sq_loc, H, hd); k, v: (B, Skv_loc, KH, hd), this rank's
    CONTIGUOUS shards (rank r owns global rows ``r*S_loc + [0, S_loc)``).
    Returns (B, Sq_loc, H, hd) in q's dtype, equal (up to fp32 reduction
    order) to ``blockwise_attention`` on the gathered sequence.  One hop
    per ctx rank, the diagonal block first; K/V rotate one position after
    every hop but the last.
    """
    cp = prim.axis_size(axis_name)
    r = prim.axis_index(axis_name)
    Sq, Skv = q.shape[1], k.shape[1]
    carry = ring_init(q)
    k_cur, v_cur = k, v
    for t in range(cp):
        # hop t: rank r holds the shard that started at rank (r - t) % cp
        carry = ring_hop(carry, q, k_cur, v_cur, q_pos0=r * Sq,
                         kv_base=((r - t) % cp) * Skv, chunk=chunk,
                         causal=causal)
        if t < cp - 1:
            k_cur = prim.ring_shift(k_cur, axis_name, 1)
            v_cur = prim.ring_shift(v_cur, axis_name, 1)
    return ring_finish(carry, q.dtype)


def ring_attention_region(q, k, v, policy, *, chunk: int,
                          causal: bool = True):
    """:func:`ring_attention` as one ``dist_jit`` region over global
    tensors (the counterpart of the reference's ``ring_attention_gspmd``).

    q: (B, S, H, hd); k, v: (B, S, KH, hd), the same on every rank of
    ``policy.mesh``.  The boundary shards the sequence over the ctx axis
    (replacing the sequence all-gather), the batch over the batch axes,
    and the heads over the model axis when they divide it.  GQA KV heads
    that do not divide the model axis are repeated to the H query heads
    outside the region, so the visiting shards align with the rank's q
    heads.  Raises ``ValueError`` without a live ctx axis or when S is not
    divisible by its size.
    """
    from .compile import dist_jit
    from .linop import PartitionSpec as P

    ctx = policy.active_ctx_axis
    if ctx is None:
        raise ValueError("ring_attention_gspmd needs a live ctx axis "
                         "(policy.active_ctx_axis is None)")
    cp = policy.ctx_size
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if S % cp or k.shape[1] % cp:
        raise ValueError(
            f"ring attention: sequence length {S} (kv {k.shape[1]}) not "
            f"divisible by ctx axis {ctx!r} size {cp} — a clamped shard "
            f"would silently drop the trailing positions")
    tp = policy.model_size
    heads = policy.phys("heads") if (policy.model_axis and H % tp == 0) else None
    if heads is not None and KH % tp:
        group = H // KH
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    kv_heads = heads if (heads is not None and k.shape[2] % tp == 0) else None
    batch = policy.phys("batch")
    q_spec = P(batch, ctx, heads, None)
    kv_spec = P(batch, ctx, kv_heads, None)

    def body(qq, kk, vv):
        return ring_attention(qq, kk, vv, ctx, chunk=chunk, causal=causal)

    return dist_jit(body, policy, (q_spec, kv_spec, kv_spec), q_spec)(q, k, v)


def attention_working_set_bytes(batch: int, seq: int, heads: int,
                                head_dim: int, *, chunk: int, cp: int = 1,
                                dtype_bytes: int = 4) -> int:
    """Per-device attention working set of the blockwise/ring path (bytes):
    q/k/v/out shards, the fp32 (m, l, acc) running stats and one
    (S_loc x chunk) fp32 score tile per head, all scaling with the LOCAL
    sequence ``S/cp``."""
    s_loc = -(-seq // cp)
    c = min(chunk, s_loc)
    qkv_out = 4 * batch * s_loc * heads * head_dim * dtype_bytes
    stats = (2 * batch * s_loc * heads +                 # m, l (fp32)
             batch * s_loc * heads * head_dim) * 4       # acc (fp32)
    scores = batch * s_loc * heads * c * 4               # one fp32 tile
    return qkv_out + stats + scores


def check_attention_budget(budget_bytes: int, batch: int, seq: int,
                           heads: int, head_dim: int, *, chunk: int,
                           cp: int = 1, dtype_bytes: int = 4) -> int:
    """The estimated per-device bytes when they fit ``budget_bytes``;
    otherwise ``ValueError`` naming the context-parallel degree that would
    fit."""
    need = attention_working_set_bytes(batch, seq, heads, head_dim,
                                       chunk=chunk, cp=cp,
                                       dtype_bytes=dtype_bytes)
    if need > budget_bytes:
        fit = cp
        while fit <= seq and attention_working_set_bytes(
                batch, seq, heads, head_dim, chunk=chunk, cp=fit,
                dtype_bytes=dtype_bytes) > budget_bytes:
            fit *= 2
        hint = (f"shard the sequence over a ctx axis (cp>={fit} fits)"
                if fit <= seq else
                "no context-parallel degree fits this budget")
        raise ValueError(
            f"attention working set ~{need/2**20:.1f} MiB/device at cp={cp} "
            f"exceeds the {budget_bytes/2**20:.1f} MiB budget; {hint}")
    return need
