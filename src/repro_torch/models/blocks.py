"""Decoder blocks: (attention | SSD mixer) + (dense MLP | MoE | none)
sub-layers (mirrors ``repro/models/blocks.py``).

A *superblock* is one period of the architecture's layer pattern (8 for
jamba's [7 x mamba + 1 x attn] interleave, 2 for alternating-MoE archs);
the model stacks its parameters on a leading dim.

Given a ``policy`` with ``explicit_tp``, ``sublayer_apply`` runs the
attention+MLP sublayer in train mode as ONE ``dist_jit`` region over the
policy's model axis (``_tp_sublayer_apply``): the residual stream enters
feature-sharded and the four projections ride the ring matmuls.  An MoE
FFN with a policy runs ``moe_apply``'s own region.  In prefill and
decode a policy means sharded serving (``check_serve_policy``): every
rank holds its own shards and runs ``_tp_sublayer_body`` on its blocks,
whatever ``explicit_tp`` says (it picks the ring matmuls or the plain
gather and scatter), the cache sharded by ``policy.kv_layout``: attention
on its heads, an SSM mixer on its SSM heads, the MLP on its d_ff block,
an MoE FFN on its experts.
``pipeline_stage_body`` is one pipeline stage on local blocks, run by the
executor of ``core/pipeline.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core import primitives as prim
from repro_torch.core.compile import dist_jit
from repro_torch.sharding import Partitioned
from repro_torch.tracing import span

from .attention import (attention_block, attention_block_sp,
                        attention_block_tp, attn_init)
from .common import (mlp_apply, mlp_apply_sp, mlp_init, rmsnorm,
                     rmsnorm_sharded, subtree)
from .moe import (moe_apply, moe_apply_sp, moe_init, moe_serve_body,
                  moe_stage_body)
from .ssm import ssm_block, ssm_block_sp, ssm_block_tp, ssm_init


def layer_kinds(cfg, layer: int) -> tuple[str, str]:
    return cfg.mixer_kind(layer), cfg.ffn_kind(layer)


def sublayer_init(cfg, layer: int, dtype, generator, stacked: int) -> dict:
    """Flat params of one layer, each leaf stacked ``(stacked, ...)``."""
    mixer, ffn = layer_kinds(cfg, layer)
    device = generator.device
    ones = torch.ones((stacked, cfg.d_model), dtype=torch.float32,
                      device=device)
    p = {"norm_mixer": ones.clone()}
    init = attn_init if mixer == "attn" else ssm_init
    p.update({f"{mixer}.{k}": v for k, v in
              init(cfg, dtype, generator, stacked).items()})
    if ffn != "none":
        p["norm_ffn"] = ones.clone()
    if ffn == "mlp":
        p.update({f"mlp.{k}": v for k, v in
                  mlp_init(cfg.d_model, cfg.d_ff, cfg.mlp_type, dtype,
                           generator, stacked).items()})
    elif ffn == "moe":
        p.update({f"moe.{k}": v for k, v in
                  moe_init(cfg, dtype, generator, stacked).items()})
    return p


def check_serve_policy(cfg, policy):
    """Refuse what sharded serving does not cover, before anything runs,
    as the reference refuses it: a mesh axis besides ``data`` and
    ``model`` and a ``kv_layout`` other than ``kvdim`` and ``kvseq``
    (``ValueError``); an expert count the model axis does not divide
    (``NotImplementedError``; the reference's expert split raises there,
    ``repro/models/moe.py:71-78``).  Every other width is served, split
    by the paper's balanced decomposition where the axis does not divide
    it, never padded: d_model (the residual's features), the query heads
    (``attention.head_block``; ``wk`` and ``wv`` whole on every rank
    where the K/V heads do not divide), head_dim under ``kvdim``, d_ff
    and the shared experts' d_ff, and the SSM heads with their d_inner
    channels (``ssm.ssm_block_of``)."""
    extra = [n for n in policy.axis_names
             if n not in (policy.data_axis, policy.model_axis)
             and policy.axis_size(n) > 1]
    if extra:
        raise ValueError(f"sharded serving runs over (data, model); the "
                         f"mesh also has {extra}")
    if policy.kv_layout not in ("kvdim", "kvseq"):
        raise ValueError(f"kv_layout {policy.kv_layout!r}: kvdim or kvseq")
    _check_experts(cfg, policy, "sharded serving")


def _check_experts(cfg, policy, program: str):
    """``NotImplementedError`` where ``cfg`` has MoE layers whose expert
    count the model axis does not divide."""
    moe = any(layer_kinds(cfg, i)[1] == "moe"
              for i in range(cfg.block_period))
    tp = policy.model_size
    if moe and cfg.num_experts % tp:
        raise NotImplementedError(
            f"{program} of {cfg.name} splits ['num_experts'] over the model "
            f"axis: {{'num_experts': {cfg.num_experts}}} not divisible by "
            f"its size {tp}")


def is_sp_policy(policy) -> bool:
    """Whether ``policy`` selects the policy train program (ZeRO-3 over
    the fsdp axes, tensor and sequence parallelism over ``model``): a
    policy with ``fsdp`` or ``seq_shard`` on, as ``Policy(mesh)`` makes
    it, without a live ctx, ep or pipe axis or ``explicit_tp`` (those keep
    the region path, as ``Policy.for_mesh``, which turns both off)."""
    return (policy is not None and (policy.fsdp or policy.seq_shard)
            and policy.active_ctx_axis is None
            and policy.active_ep_axis is None and policy.pipe_size == 1
            and not policy.explicit_tp)


def check_train_policy(cfg, policy):
    """Refuse what the policy train program does not cover, before
    anything runs: a mesh axis besides pod, data and model, or a policy
    without ``seq_shard`` (``ValueError``); an expert count the model
    axis does not divide (``NotImplementedError``, as the reference).
    Every other width trains: a leaf whose dim the model axis does not
    divide stays whole over it, as the reference's ``param_spec`` leaves
    it, and each rank takes its balanced block of the heads it computes:
    the query heads (``wq``/``wo``), the K/V heads its query heads attend
    (``attention_block_sp``), the SSM heads and their d_inner channels
    (``ssm_block_sp``); a d_ff or vocabulary the axis does not divide is
    computed whole on every rank."""
    extra = [n for n in policy.axis_names
             if n not in (policy.pod_axis, policy.data_axis,
                          policy.model_axis) and policy.axis_size(n) > 1]
    if extra:
        raise ValueError(f"the policy train program runs over (pod, data, "
                         f"model); the mesh also has {extra}")
    if not policy.seq_shard:
        raise ValueError("the policy train program shards the residual's "
                         "sequence over the model axis: seq_shard=True")
    _check_experts(cfg, policy, "the policy train program")


def superblock_apply_sp(p, specs, x, cfg, policy, *, positions, fsdp_axes):
    """One superblock of the policy train program on this rank: ``x`` the
    residual's (B/dp, S_loc, d) shard (the balanced split of S), ``p`` this rank's blocks of the
    superblock's leaves laid out by ``specs`` (without the stack dim).
    Each layer: x + mixer(norm(x)); x + ffn(norm(x)), the norms on the
    sequence shard through the RMSNorm kernel, each sublayer gathering
    the sequence and its weights inside.  Returns (x, aux), aux the MoE
    load-balance loss summed over the period."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seq = positions.shape[1]
    for i in range(cfg.block_period):
        mixer, ffn = layer_kinds(cfg, i)
        pp, ss = subtree(p, f"pos{i}"), subtree(specs, f"pos{i}")
        h = rmsnorm(x, pp["norm_mixer"])
        with span(f"model.{mixer}"):
            if mixer == "attn":
                x = x + attention_block_sp(subtree(pp, "attn"),
                                           subtree(ss, "attn"), h, cfg,
                                           policy, positions=positions,
                                           fsdp_axes=fsdp_axes)
            else:
                x = x + ssm_block_sp(subtree(pp, "ssm"), subtree(ss, "ssm"),
                                     h, cfg, policy, fsdp_axes=fsdp_axes,
                                     seq=seq)
        if ffn == "none":
            continue
        h = rmsnorm(x, pp["norm_ffn"])
        with span("model.ffn"):
            if ffn == "mlp":
                x = x + mlp_apply_sp(h, subtree(pp, "mlp"),
                                     subtree(ss, "mlp"), cfg.mlp_type, policy,
                                     fsdp_axes, seq)
            else:
                y, aux_i = moe_apply_sp(h, subtree(pp, "moe"),
                                        subtree(ss, "moe"), cfg, policy,
                                        fsdp_axes, seq)
                x = x + y
                aux = aux + aux_i
    return x, aux


def _tp_fusable(cfg, policy, mixer, ffn, mode) -> bool:
    """The explicit-TP fused path covers the attention+MLP sublayer in
    training, and every sublayer in prefill and decode under a policy
    (sharded serving, as far as ``check_serve_policy`` admits it);
    everything else keeps the single-device path in training.  Unlike
    the reference's, the fused body attends through ``ops.flash_attention``
    as the port's ``attention_block`` does, so there is no flash request
    for it to refuse."""
    if policy is not None and mode != "train":
        return True
    if policy is None or not getattr(policy, "explicit_tp", False):
        return False
    if mode != "train" or mixer != "attn" or ffn not in ("mlp", "none"):
        return False
    tp = policy.model_size
    return (cfg.d_model % tp == 0 and cfg.num_heads % tp == 0
            and cfg.num_kv_heads % tp == 0 and cfg.d_ff % tp == 0)


def _tp_sublayer_body(p, x, positions, cfg, policy, ffn, *, mixer="attn",
                      mode="train", cache=None, index: int = 0,
                      cache_len=None):
    """Whole sublayer on local blocks: ONE region spans both the mixer and
    FFN halves, so their ring matmuls (qkv-gather, out-scatter, up-gather,
    down-scatter) can overlap compute across the halves.
    x: (B_loc, S, d_loc), this rank's block of d_model (the balanced
    split in serving where the axis does not divide it; ``_tp_fusable``
    keeps the training regions to widths it divides).  In prefill and
    decode (sharded serving)
    ``cache``/``index``/``cache_len`` reach the mixer, which is attention
    (``attention_block_tp``) or, in serving only, the SSM mixer on this
    rank's heads (``ssm_block_tp``); ``ffn`` is the dense MLP on this
    rank's d_ff block (the balanced split where the axis does not divide
    it), none, or in serving the MoE FFN on this rank's experts
    (``moe_serve_body``)."""
    ax = policy.model_axis
    h = rmsnorm_sharded(x, p["norm_mixer"], ax, cfg.d_model)
    if mixer == "attn":
        x = x + attention_block_tp(subtree(p, "attn"), h, cfg, policy,
                                   positions=positions, mode=mode,
                                   cache=cache, index=index,
                                   cache_len=cache_len)
    else:
        x = x + ssm_block_tp(subtree(p, "ssm"), h, cfg, policy, mode=mode,
                             cache=cache, index=index)
    if ffn == "none":
        return x
    h = rmsnorm_sharded(x, p["norm_ffn"], ax, cfg.d_model)
    if ffn == "moe":
        return x + moe_serve_body(h, subtree(p, "moe"), cfg, policy)
    mp = subtree(p, "mlp")
    up = L.affine_gather(h, mp["w_up"], axis=ax)
    if cfg.mlp_type == "swiglu":
        up = F.silu(L.affine_gather(h, mp["w_gate"], axis=ax)) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return x + L.affine_scatter(up, mp["w_down"], axis=ax)


def _tp_sublayer_apply(p, x, cfg, policy, *, positions, ffn):
    """dist_jit wrapper of the fused sublayer: logical ``Partitioned`` specs
    at the boundary, the residual's features over the model axis.  With a
    live ctx axis the sequence dim also stays sharded at the boundary
    ("ctx" resolves replicated otherwise), so the region composes ring
    attention on ``ctx`` with the ring matmuls on ``model``; the global
    positions are cut with it (the boundary refuses a sequence the ctx
    axis does not divide)."""
    m = Partitioned("model")
    col = Partitioned(None, "model")   # (in, out-shard) projections
    row = Partitioned("model", None)   # (in-shard, out) projections
    p_parts = {"norm_mixer": m, "attn.wq": col, "attn.wk": col,
               "attn.wv": col, "attn.wo": row}
    if ffn == "mlp":
        p_parts["norm_ffn"] = m
        p_parts.update({k: (row if k == "mlp.w_down" else col)
                        for k in p if k.startswith("mlp.")})
    p_in = {k: p[k] for k in p_parts}
    xp = Partitioned("batch", "ctx", "model")

    def body(pp, xx, pos):
        return _tp_sublayer_body(pp, xx, pos, cfg, policy, ffn)

    return dist_jit(body, policy,
                    (p_parts, xp, Partitioned("batch", "ctx")),
                    xp)(p_in, x, positions)


def sublayer_apply(p, x, cfg, layer: int, *, positions, mode, cache=None,
                   index: int = 0, cache_len=None, policy=None,
                   ctx_axis=None):
    """One decoder layer: x + mixer(norm(x)); x + ffn(norm(x)).

    ``index`` is this superblock's position in the stack (the slice of the
    stacked decode cache it owns).  Returns (x, state, aux): the mixer's
    prefill cache entries (``{"k", "v"}`` or ``{"conv", "ssm"}``, else
    None) and the MoE load-balance loss (0 without an MoE FFN).  With a
    ``policy`` whose ``explicit_tp`` is set, the train-mode attention+MLP
    sublayer runs as one region over its model axis
    (``_tp_sublayer_apply``); an MoE FFN with a policy runs
    ``moe_apply``'s region.  x, positions and p are then the global
    values, the same on every rank of the policy's mesh.  In prefill and
    decode a policy means sharded serving: p and x are this rank's blocks
    (x feature-sharded), run by ``_tp_sublayer_body`` inside the caller's
    region, and the cache is this rank's part.  ``ctx_axis``:
    the live ctx axis when x is this rank's sequence shard inside a region
    (the pipeline stage body); attention then rings over it and
    ``positions`` must be global.
    """
    mixer, ffn = layer_kinds(cfg, layer)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _tp_fusable(cfg, policy, mixer, ffn, mode):
        if mode != "train":
            return _tp_sublayer_body(p, x, positions, cfg, policy, ffn,
                                     mixer=mixer, mode=mode, cache=cache,
                                     index=index, cache_len=cache_len), \
                None, aux
        return _tp_sublayer_apply(p, x, cfg, policy, positions=positions,
                                  ffn=ffn), None, aux
    h = rmsnorm(x, p["norm_mixer"])
    if mixer != "attn":
        _refuse_ssm_under_ctx(ctx_axis)
    with span(f"model.{mixer}"):
        if mixer == "attn":
            out, kv = attention_block(subtree(p, "attn"), h, cfg,
                                      positions=positions, mode=mode,
                                      cache=cache, index=index,
                                      cache_len=cache_len, ctx_axis=ctx_axis,
                                      policy=policy)
        else:
            out, kv = ssm_block(subtree(p, "ssm"), h, cfg, mode=mode,
                                cache=cache, index=index)
    x = x + out
    if ffn != "none":
        h = rmsnorm(x, p["norm_ffn"])
        with span("model.ffn"):
            if ffn == "mlp":
                out = mlp_apply(h, subtree(p, "mlp"), cfg.mlp_type)
            else:
                out, aux = moe_apply(h, subtree(p, "moe"), cfg, policy)
        x = x + out
    return x, kv, aux


def _refuse_ssm_under_ctx(ctx_axis):
    if ctx_axis is not None:
        raise NotImplementedError(
            f"an SSM mixer over a live ctx axis ({ctx_axis!r}) is refused: "
            f"the reference scans each sequence shard from zero state (its "
            f"conv and scan carry nothing across ctx ranks), which is not "
            f"the global scan; run SSM archs with CP = 1")


def pipeline_stage_body(p_stage, x, cfg, policy, *, positions):
    """One pipeline STAGE on local blocks: its stack of superblocks, run in
    the pipeline executor's region (``core/pipeline.py``).

    p_stage: this stage's superblocks, each leaf stacked ``(n_super_per_
    stage, ...)``.  x: the local activation, ``(B_mb, S, d_model/tp)``
    feature-sharded when ``policy.explicit_tp`` (the fused ring-TP sublayer
    bodies run inside the region, so TP collectives compose with the pipe
    axis), else the full-feature ``(B_mb, S, d_model)`` residual through
    the ordinary ``sublayer_apply`` (kernels and all).  Training math only.

    MoE sublayers run through :func:`models.moe.moe_stage_body` (dispatch
    and combine as AllToAll adjoints on the live ep axis, DESIGN §8) and
    the stage RETURNS ``(x, aux)``: the summed load-balance loss rides the
    executor's ``stage_aux`` channel.  Dense configs return the bare
    activation.  Under explicit TP the MoE half gathers the feature-sharded
    residual to the full width (``all_gather_replicated``), runs the same
    dispatch on every model rank, and restricts the result back to the
    rank's own block (``shard_slice_replicated``); each such sublayer needs
    an attention mixer.

    Under context parallelism x is the ctx rank's sequence shard,
    ``positions`` are global, and attention rings over the ctx axis in
    both branches (the ctx, pipe and model axes all live in the one
    region).  An SSM mixer over a live ctx axis raises
    ``NotImplementedError``: the reference scans each shard from zero
    state, which is not the global scan.
    """
    explicit = policy is not None and getattr(policy, "explicit_tp", False)
    ctx_axis = policy.active_ctx_axis if policy is not None else None
    ep_axis = policy.active_ep_axis if policy is not None else None
    # the axes the stage's tokens shard over: the MoE aux statistics reduce
    # over exactly these, so aux is the global-microbatch value everywhere
    stat_axes = tuple(a for a in (
        policy.active_data_axis if policy is not None else None, ctx_axis,
        ep_axis) if a)
    kinds = [layer_kinds(cfg, i) for i in range(cfg.block_period)]
    has_moe = any(ffn == "moe" for _, ffn in kinds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # unbind: each stacked leaf's grad is one stack of per-superblock grads
    layers = {k: v.unbind(0) for k, v in p_stage.items()}
    n = len(next(iter(layers.values())))
    for j in range(n):
        p_blk = {k: v[j] for k, v in layers.items()}
        for i, (mixer, ffn) in enumerate(kinds):
            pp = subtree(p_blk, f"pos{i}")
            if ffn == "moe":
                if explicit:
                    if mixer != "attn":
                        raise NotImplementedError(
                            "explicit-TP pipeline stages support attention "
                            f"mixers with MoE FFNs, got ({mixer}, {ffn})")
                    ax = policy.model_axis
                    x = _tp_sublayer_body(pp, x, positions, cfg, policy,
                                          "none")
                    h = rmsnorm_sharded(x, pp["norm_ffn"], ax, cfg.d_model)
                    h = prim.all_gather_replicated(h, ax, 2)
                    y, aux_i = moe_stage_body(h, subtree(pp, "moe"), cfg,
                                              ep_axis=ep_axis,
                                              stat_axes=stat_axes)
                    x = x + prim.shard_slice_replicated(y, ax, 2)
                else:
                    h = rmsnorm(x, pp["norm_mixer"])
                    if mixer == "attn":
                        out, _ = attention_block(subtree(pp, "attn"), h, cfg,
                                                 positions=positions,
                                                 mode="train",
                                                 ctx_axis=ctx_axis)
                    else:
                        _refuse_ssm_under_ctx(ctx_axis)
                        out, _ = ssm_block(subtree(pp, "ssm"), h, cfg,
                                           mode="train")
                    x = x + out
                    h = rmsnorm(x, pp["norm_ffn"])
                    y, aux_i = moe_stage_body(h, subtree(pp, "moe"), cfg,
                                              ep_axis=ep_axis,
                                              stat_axes=stat_axes)
                    x = x + y
                aux = aux + aux_i
            elif explicit:
                if mixer != "attn" or ffn not in ("mlp", "none"):
                    raise NotImplementedError(
                        "explicit-TP pipeline stages support attention + "
                        f"dense-FFN sublayers, got ({mixer}, {ffn})")
                x = _tp_sublayer_body(pp, x, positions, cfg, policy, ffn)
            else:
                x, _, _ = sublayer_apply(pp, x, cfg, i, positions=positions,
                                         mode="train", ctx_axis=ctx_axis)
    return (x, aux) if has_moe else x


def superblock_init(cfg, dtype, generator, stacked: int) -> dict:
    out = {}
    for i in range(cfg.block_period):
        out.update({f"pos{i}.{k}": v for k, v in
                    sublayer_init(cfg, i, dtype, generator, stacked).items()})
    return out


def superblock_apply(p, x, cfg, *, positions, mode, cache=None, index: int = 0,
                     cache_len=None, policy=None):
    """Apply one superblock (period consecutive layers).

    cache: flat ``{"pos{i}.<leaf>": stacked cache}`` (decode) or None.
    Returns (x, {"pos{i}.<leaf>": this superblock's cache entries}, aux):
    the entries are K/V or the conv and SSM states, filled in prefill only;
    aux is the MoE load-balance loss summed over the period.
    """
    new_kv = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.block_period):
        sub_cache = subtree(cache, f"pos{i}") if cache is not None else None
        x, kv, aux = sublayer_apply(subtree(p, f"pos{i}"), x, cfg, i,
                                    positions=positions, mode=mode,
                                    cache=sub_cache, index=index,
                                    cache_len=cache_len, policy=policy)
        aux_total = aux_total + aux
        if kv is not None:
            new_kv.update({f"pos{i}.{k}": t for k, t in kv.items()})
    return x, new_kv, aux_total
