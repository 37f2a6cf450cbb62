"""Mamba2 (SSD, state-space duality) sequence mixer (mirrors
``repro/models/ssm.py``).

Train and prefill run the chunked SSD scan through ``kernels.ops.ssd_scan``:
the hand-written CUDA kernel on the card, ``kernels/ref.py::ssd_chunked`` on
the host (imported here too, as the reference's ``ssm.py`` defines it).
``ssd_chunked`` is the chunk step of the reference written as a Python loop
over chunks (the reference's ``lax.scan``); the O(1)-state decode step is
plain PyTorch, as in the reference.

Under a serve policy (``ssm_block_tp``, prefill and decode) every rank
runs the mixer on its own SSM heads: the reference's split
(``repro/sharding/policy.py:315-319``: in_z, in_x, in_dt, conv_w and the
per-head vectors over ``model``, out_proj by rows, in_B and in_C whole)
with its heads over ``model`` (``repro/models/ssm.py:157-158``).  The conv
and the scan are head-local, so the only collectives are the features'
gather, the gated norm's all-reduce and out_proj's reduce-scatter.  Where
the model axis does not divide the SSM heads (mamba2-370m's 32 over 3),
each rank holds its block of the paper's balanced split of the heads
(``local_ssm_heads``: 11, 11, 10) and the d_inner channels of those heads
(704, 704, 640): a block of d_inner aligned to heads, never a cut through
one.  The policy train program leaves such leaves whole over ``model``,
as the reference's ``param_spec``, and each rank takes the same block of
them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core import primitives as prim
from repro_torch.core.partition import balanced_split
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (re-exported)

from .attention import head_block
from .common import (dense_init, gather_block, normal_init, rmsnorm,
                     rmsnorm_sharded, seq_gather, seq_scatter)

# the leaves split over ``model`` along their SSM heads, and the dim: per
# head (in_dt's columns, the per-head vectors) or per channel, head_dim of
# them a head (in_z's and in_x's columns, conv_w's channels, ssm_norm,
# out_proj's rows)
HEAD_LEAVES = {"in_dt": 1, "a_log": 0, "d_skip": 0, "dt_bias": 0}
CHANNEL_LEAVES = {"in_z": 1, "in_x": 1, "conv_w": 1, "ssm_norm": 0,
                  "out_proj": 0}


def ssm_init(cfg, dtype, generator, stacked: int = 0) -> dict:
    """Same leaves, shapes and distributions as the reference
    (``ssm.py:28-51``); each leaf stacked ``(stacked, ...)`` when asked."""
    d, din, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, k = cfg.ssm_heads, cfg.conv_kernel
    device = generator.device
    lead = (stacked,) if stacked else ()

    def const(value, n):
        return torch.full(lead + (n,), value, dtype=torch.float32,
                          device=device)

    # A in [1, 16) as in the mamba2 reference init: log A uniform in [0, log 16)
    a_log = torch.rand(lead + (nh,), generator=generator,
                       device=device) * math.log(16.0)
    return {
        "in_z": dense_init(d, din, dtype, generator, stacked),
        "in_x": dense_init(d, din, dtype, generator, stacked),
        "in_B": dense_init(d, ds, dtype, generator, stacked),
        "in_C": dense_init(d, ds, dtype, generator, stacked),
        "in_dt": dense_init(d, nh, dtype, generator, stacked),
        "conv_w": normal_init((k, din), 1.0 / math.sqrt(k), dtype, generator,
                              stacked=stacked),
        "a_log": a_log,
        "d_skip": const(1.0, nh),
        "dt_bias": const(0.0, nh),
        "ssm_norm": const(1.0, din),
        "out_proj": dense_init(din, d, dtype, generator, stacked),
    }


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (k, C).

    state: (B, k-1, C) carry-in for decode; returns (y, new_state), the new
    state being the last k-1 inputs.  The same sum of k shifted products as
    the reference, not ``F.conv1d``: cuDNN's fp32 convolution runs in TF32
    by default.  For k = 1 the state is an empty (B, 0, C) tensor where the
    reference returns None.
    """
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(k))
    return y, xp[:, xp.shape[1] - (k - 1):, :]


def ssd_decode_step(x, dt, a_neg, Bm, Cm, h):
    """Single-token recurrence: h' = exp(dt*A) h + dt * B x ;  y = C . h'.

    x: (B, 1, H, P); dt: (B, 1, H); Bm/Cm: (B, 1, N); h: (B, H, P, N).
    Returns (y (B, 1, H, P) in x's dtype, h')."""
    xf = x.float()[:, 0]                                 # (B,H,P)
    dtf = dt.float()[:, 0]                               # (B,H)
    bf = Bm.float()[:, 0]                                # (B,N)
    cf = Cm.float()[:, 0]
    decay = torch.exp(dtf * a_neg[None, :])              # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dtf, xf, bf)
    h_new = h * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cf, h_new)
    return y[:, None].to(x.dtype), h_new


def ssm_block(p, x, cfg, *, mode, cache=None, index: int = 0):
    """Full Mamba2 sub-layer (``ssm.py:145-186``).  x: (B, S, d).

    Returns (out, state): ``state`` is ``{"conv", "ssm"}`` of this call in
    prefill and None in train and decode.  Decode reads and writes
    ``cache["conv"][index]`` and ``cache["ssm"][index]`` (the slice of the
    stacked cache this superblock owns) IN PLACE, where the reference
    returns an updated copy.
    """
    nh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    Bm = x @ p["in_B"]
    Cm = x @ p["in_C"]
    dt = x @ p["in_dt"]

    conv_state = cache["conv"][index] if mode == "decode" else None
    xs, new_conv = causal_conv1d(xs, p["conv_w"], conv_state)
    xs = F.silu(xs)

    dt = F.softplus(dt.float() + p["dt_bias"])
    a_neg = -torch.exp(p["a_log"])
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, pd)

    if mode == "decode":
        y, h_new = ssd_decode_step(xh, dt, a_neg, Bm, Cm, cache["ssm"][index])
    else:
        y, h_new = ops.ssd_scan(xh, dt, a_neg, Bm, Cm,
                                chunk=min(64, xs.shape[1]))
    y = y + (p["d_skip"][None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(xs.shape)

    # gated RMSNorm (mamba2): norm(y * silu(z)), the product in the model dtype
    y = rmsnorm(y * F.silu(z), p["ssm_norm"])
    out = y @ p["out_proj"]

    if mode == "decode":
        cache["conv"][index].copy_(new_conv)
        cache["ssm"][index].copy_(h_new)
    state = {"conv": new_conv, "ssm": h_new} if mode == "prefill" else None
    return out, state


def ssm_block_of(cfg, name: str, tp: int, index: int):
    """``(dim, start, length)`` of rank ``index``'s block of the SSM leaf
    ``name`` (unstacked) over a ``tp``-way model axis: its heads
    (``head_block`` of the SSM heads) or those heads' channels; None
    for a leaf every rank holds whole (in_B, in_C)."""
    first, n = head_block(cfg.ssm_heads, tp, index)
    if name in HEAD_LEAVES:
        return HEAD_LEAVES[name], first, n
    if name in CHANNEL_LEAVES:
        pd = cfg.ssm_head_dim
        return CHANNEL_LEAVES[name], first * pd, n * pd
    return None


def local_ssm_heads(cfg, policy) -> tuple[int, int]:
    """``head_block`` of the SSM heads for this rank along ``policy``'s
    model axis."""
    return head_block(cfg.ssm_heads, policy.model_size,
                      prim.axis_index(policy.model_axis))


def ssm_block_tp(p, h, cfg, policy, *, mode, cache, index: int = 0):
    """The Mamba2 sub-layer on this rank's SSM heads, for sharded serving
    (prefill and decode, inside the serving region).

    h: (B_loc, S, d_loc), the normed residual feature-sharded over the
    model axis (the balanced split of d_model).  p: this rank's shards
    (module docstring).  The features are gathered once; z, x and dt come
    from this rank's column blocks, B and C from the whole in_B and in_C;
    the causal conv runs on this rank's channels and the scan
    (``ops.ssd_scan`` in prefill, ``ssd_decode_step`` in decode) on its
    heads (``local_ssm_heads``) with the whole B and C; the gated norm's
    mean of squares is over the global d_inner (``rmsnorm_sharded``);
    out_proj's row block reduce-scatters into the residual's feature
    split.  ``cache``: this rank's part of ``models.init_cache(...,
    policy=)``; prefill writes the prompt's final conv and SSM states into
    ``cache["conv"][index]`` and ``cache["ssm"][index]`` in place, decode
    reads and updates them.  Returns the sub-layer's output, (B_loc, S,
    d_loc)."""
    ax = policy.model_axis
    nh, pd = local_ssm_heads(cfg, policy)[1], cfg.ssm_head_dim
    x = prim.all_gather(h, ax, 2, balanced_split(cfg.d_model,
                                                   policy.model_size))
    z = x @ p["in_z"]
    xs = x @ p["in_x"]
    Bm = x @ p["in_B"]
    Cm = x @ p["in_C"]
    dt = x @ p["in_dt"]

    conv, ssm = cache["conv"][index], cache["ssm"][index]
    xs, new_conv = causal_conv1d(xs, p["conv_w"],
                                 conv if mode == "decode" else None)
    xs = F.silu(xs)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a_neg = -torch.exp(p["a_log"])
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, pd)
    if mode == "decode":
        y, h_new = ssd_decode_step(xh, dt, a_neg, Bm, Cm, ssm)
    else:
        y, h_new = ops.ssd_scan(xh, dt, a_neg, Bm, Cm,
                                chunk=min(64, xs.shape[1]))
    y = y + (p["d_skip"][None, None, :, None] * xh.float()).to(y.dtype)
    y = rmsnorm_sharded(y.reshape(xs.shape) * F.silu(z), p["ssm_norm"], ax,
                        cfg.d_inner)
    conv.copy_(new_conv)
    ssm.copy_(h_new)
    return L.affine_scatter(y, p["out_proj"], axis=ax)


def ssm_block_sp(p, specs, h, cfg, policy, *, fsdp_axes, seq: int):
    """The Mamba2 sub-layer of the policy train program on this rank
    (``models.forward`` under a policy with ``seq_shard``), on its SSM
    heads: the reference's ``param_spec`` split (in_z, in_x, in_dt,
    conv_w and the per-head vectors over ``model``, out_proj by rows,
    in_B and in_C on the fsdp axes only), each weight gathered over the
    fsdp axes right before its use.

    h: (B/dp, S_loc, d), the normed residual's sequence shard (``seq``
    the global length).  The sequence is gathered whole (the conv and the scan run over all of it,
    on this rank's channels and heads, through ``ops.ssd_scan``); B and C
    come from the whole in_B and in_C, the same on every model rank; the
    gated norm's mean of squares is over the global d_inner
    (``rmsnorm_sharded``; the kernel when the model axis has one rank);
    out_proj's row block reduce-scatters the partial output back onto the
    sequence shard.  Where ``model`` does not divide the SSM heads, every
    leaf split by heads or channels is gathered whole over ``model`` too
    (the spec leaves it whole where the axis does not divide its dim) and
    each rank takes its head-aligned block (``ssm_block_of``); its
    gradient returns through the gather's adjoint or, for a leaf the spec
    leaves whole, the sum over ``model`` after the backward, each rank
    contributing zero outside its block."""
    ax = policy.model_axis
    tp = policy.model_size
    nh, pd = local_ssm_heads(cfg, policy)[1], cfg.ssm_head_dim
    whole = cfg.ssm_heads % tp != 0
    axes = fsdp_axes + ((ax,) if whole else ())
    me = prim.axis_index(ax)
    x = seq_gather(h, ax, seq)

    def leaf(name):
        w = gather_block(p[name], specs[name], axes)
        blk = ssm_block_of(cfg, name, tp, me) if whole else None
        return w if blk is None else w.narrow(*blk)

    z, xs, Bm, Cm, dt = (x @ leaf(n) for n in ("in_z", "in_x", "in_B",
                                               "in_C", "in_dt"))
    xs, _ = causal_conv1d(xs, leaf("conv_w"))
    xs = F.silu(xs)
    dt = F.softplus(dt.float() + leaf("dt_bias"))
    a_neg = -torch.exp(leaf("a_log"))
    xh = xs.reshape(xs.shape[0], xs.shape[1], nh, pd)
    y, _ = ops.ssd_scan(xh, dt, a_neg, Bm, Cm, chunk=min(64, xs.shape[1]))
    y = y + (leaf("d_skip")[None, None, :, None] * xh.float()).to(y.dtype)
    y = y.reshape(xs.shape) * F.silu(z)
    y = (rmsnorm_sharded(y, leaf("ssm_norm"), ax, cfg.d_inner) if tp > 1
         else rmsnorm(y, leaf("ssm_norm")))
    y = y @ leaf("out_proj")
    return seq_scatter(y, ax, tp > 1)
