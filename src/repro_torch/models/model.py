"""DecoderLM: the decoder-only model (mirrors ``repro/models/model.py``).

Dense, MoE (kimi, llama4), hybrid (jamba), SSM (mamba2) and stub-frontend
(musicgen, pixtral: ``{"embeds": (B, S, d)}`` in place of tokens)
architectures.  The superblock parameters are stacked on a leading dim, as
the reference's scan layout (``model.py:32``), and applied by a Python
loop.  The pipeline cut (``to_pipeline_params`` ... ``pipeline_fns``)
feeds ``core/pipeline.py``.  Sharded serving over a (data, model) mesh
(``forward(..., policy=)`` in prefill and decode) runs on each rank's
shards: ``shard_params`` cuts them from the global tree,
``init_rank_params`` draws them on the rank's card alone, and
``init_cache(..., policy=)`` allocates the rank's part of the cache.

Modes:
  train   — full sequence, returns logits
  prefill — full sequence, also returns the KV / conv / SSM caches
  decode  — single token against the caches (updated in place)
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core import primitives as prim
from repro_torch.core.compile import local_blocks, region
from repro_torch.core.linop import PartitionSpec as P
from repro_torch.core.partition import balanced_split, shard_offsets
from repro_torch.device import resolve_device
from repro_torch.sharding import Partitioned

from .attention import head_block
from .blocks import (check_serve_policy, check_train_policy, is_sp_policy,
                     pipeline_stage_body, superblock_apply,
                     superblock_apply_sp, superblock_init)
from .common import (dense_init, gather_block, normal_init, rmsnorm,
                     seq_gather, seq_scatter, spec_axes, spec_names, subtree)
from .moe import EXPERT_LEAVES
from .ssm import ssm_block_of

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def embed_lookup(table, tokens):
    """Rows ``tokens`` of the embedding ``table``.  ``F.embedding``, not
    advanced indexing: on the host the indexing's backward (an
    accumulating ``index_put_``) sums the rows' gradients in an order that
    varies with the threads, while the embedding's backward is bitwise
    repeatable there as on the card, which the checkpoint replays' exact
    equality with an uninterrupted run needs."""
    return F.embedding(tokens, table)


def init_params(cfg, generator, device=None, dtype=None) -> dict:
    """Random parameters at ``cfg``'s widths, as ``{name: Tensor}``.

    Same distributions as the reference (``common.py:62-76``): N(0, 1/d_in)
    weights, unit norm weights in fp32.  ``generator``, a ``torch.Generator``
    on ``device``, replaces the JAX key.  ``device`` defaults to ``cuda``
    and raises without a card; ``dtype`` defaults to ``cfg.dtype``.
    """
    device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    n_super = cfg.num_layers // cfg.block_period
    params = {
        "embed": dense_init(cfg.vocab_size, cfg.d_model, dtype, generator),
        "norm_final": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=device),
    }
    params.update({f"blocks.{k}": v for k, v in
                   superblock_init(cfg, dtype, generator, n_super).items()})
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, dtype,
                                       generator)
    return params


# ---------------------------------------------------------------------------
# Pipeline-parallel model cut (``core/pipeline.py`` executor glue).
#
# The decoder is cut into S homogeneous stages along the layer axis: each
# stacked superblock leaf (n_super, ...) is re-stacked to (S, n_super/S,
# ...) with the leading dim over the pipe mesh axis, the embedding becomes
# the stage-0 prologue and the final norm + head the last-stage epilogue.
# Flat keys: ``pre.embed``, ``stage.pos0.attn.wq``, ``post.norm_final``,
# ``post.lm_head``; weights keep JAX's (d_in, d_out) layout.  No leaf names
# the data axis: on a hybrid mesh every leaf is replicated across replicas
# (the paper's broadcast B, whose adjoint is the drain-tail sum-reduce).
# ---------------------------------------------------------------------------

def _check_pipelineable(cfg):
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "pipeline cut needs untied embeddings (the tied table would "
            "live on both the first and last stage)")
    if cfg.frontend != "none":
        raise NotImplementedError(
            "pipeline cut supports token frontends only")


def to_pipeline_params(cfg, params, num_stages: int) -> dict:
    """Re-cut a dense params dict into ``pre.*``/``stage.*``/``post.*`` for
    ``num_stages`` pipeline stages (stage leaves stacked (S, n_super/S,
    ...), views of the dense leaves)."""
    _check_pipelineable(cfg)
    n_super = cfg.num_layers // cfg.block_period
    if num_stages < 1 or n_super % num_stages:
        raise ValueError(
            f"{n_super} superblocks do not assign uniformly to "
            f"{num_stages} stages (the executor needs equal stages)")
    per = n_super // num_stages
    out = {"pre.embed": params["embed"]}
    out.update({f"stage.{k}": v.reshape((num_stages, per) + v.shape[1:])
                for k, v in subtree(params, "blocks").items()})
    out["post.norm_final"] = params["norm_final"]
    out["post.lm_head"] = params["lm_head"]
    return out


def from_pipeline_params(pparams) -> dict:
    """Inverse of ``to_pipeline_params``: back to the dense layout."""
    out = {"embed": pparams["pre.embed"]}
    out.update({f"blocks.{k}": v.reshape((v.shape[0] * v.shape[1],)
                                         + v.shape[2:])
                for k, v in subtree(pparams, "stage").items()})
    out["norm_final"] = pparams["post.norm_final"]
    out["lm_head"] = pparams["post.lm_head"]
    return out


def init_pipeline_params(cfg, generator, num_stages: int, device=None,
                         dtype=None) -> dict:
    """Random parameters directly in the pipeline-stage layout (the
    GLOBAL tree; ``convert.to_rank_params`` cuts one rank's blocks)."""
    return to_pipeline_params(cfg, init_params(cfg, generator, device, dtype),
                              num_stages)


def pipeline_param_parts(cfg, policy, pparams) -> dict:
    """``Partitioned`` declarations for a pipeline params dict.

    Stage leaves lead with the ``pipe`` axis (the stacked stage dim); under
    ``policy.explicit_tp`` the projection/norm leaves also carry their
    model-axis TP sharding (the fused TP sublayer's specs).  MoE expert
    weights shard their E dim over the logical ``ep`` axis (the live ep
    axis, replicated otherwise; DESIGN §8); the router and shared-expert
    leaves stay replicated over ep and model (their dispatch runs the same
    on every ep rank, and on every model rank under explicit TP).  pre/post
    leaves stay replicated."""
    explicit = policy is not None and getattr(policy, "explicit_tp", False)
    col = Partitioned("pipe", None, None, "model")
    row = Partitioned("pipe", None, "model", None)
    vec = Partitioned("pipe", None, "model")
    tp_table = {"wq": col, "wk": col, "wv": col, "wo": row,
                "w_up": col, "w_gate": col, "w_down": row,
                "norm_mixer": vec, "norm_ffn": vec}
    # (S, per, E, ..., ...): E, dim 2, splits over the ep axis
    expert_part = Partitioned("pipe", None, "ep", None, None)

    def part(key):
        if not key.startswith("stage."):
            return Partitioned()
        name = key.rsplit(".", 1)[-1]
        if ".moe." in key:
            return expert_part if name in EXPERT_LEAVES else Partitioned("pipe")
        if explicit and name in tp_table:
            return tp_table[name]
        return Partitioned("pipe")
    return {k: part(k) for k in pparams}


def pipeline_fns(cfg, policy, aux_weight: float = 0.01):
    """(pre_fn, stage_fn, logits_fn) for the pipeline executor.

    pre_fn embeds a token microbatch (and feature-shards the residual under
    explicit TP: its parameter cotangent is then in contribution form over
    the model axis, the executor's ``pre_psum_axes``); stage_fn applies
    this stage's superblocks; logits_fn gathers the features back and
    applies the final norm and head.  MoE configs make stage_fn return
    ``(act, aux_weight * aux)``, the stage's weighted load-balance loss on
    the executor's ``stage_aux`` channel (the ``aux_weight`` default of
    ``train.build_loss_fn``); dense configs return the bare activation.
    Call the three inside a region (``core/compile.py``)."""
    from repro_torch.core import layers as L
    from repro_torch.core import primitives as prim

    _check_pipelineable(cfg)
    explicit = policy is not None and getattr(policy, "explicit_tp", False)
    dtype = DTYPES[cfg.dtype]

    def pre_fn(p_pre, mb):
        x = embed_lookup(p_pre["embed"], mb["tokens"]).to(dtype)
        if explicit:
            x = L.shard_slice(x, policy.model_axis, x.ndim - 1)
        return x

    ctx = policy.active_ctx_axis if policy is not None else None

    def stage_fn(p_stage, x):
        B, S_loc = x.shape[:2]
        # Under context parallelism x is the ctx rank's sequence shard:
        # RoPE and the ring's causal mask key on GLOBAL positions, so they
        # start at the rank's first row.
        pos0 = prim.axis_index(ctx) * S_loc if ctx is not None else 0
        positions = (pos0 + torch.arange(S_loc, device=x.device))[
            None, :].expand(B, S_loc)
        out = pipeline_stage_body(p_stage, x, cfg, policy,
                                  positions=positions)
        if cfg.num_experts:
            y, aux = out
            return y, aux_weight * aux
        return out

    def logits_fn(p_post, y):
        if explicit:
            # the epilogue's loss is the same on every model rank, so the
            # gather's adjoint is the restriction to the rank's own block
            y = prim.all_gather_replicated(y, policy.model_axis, y.ndim - 1)
        return rmsnorm(y, p_post["norm_final"]) @ p_post["lm_head"]

    return pre_fn, stage_fn, logits_fn


def init_cache(cfg, batch: int, max_seq: int, device=None,
               policy=None) -> dict:
    """Zeroed decode caches, stacked per superblock as the reference's scan
    layout (``model.py:212-230``): for an attention position
    ``pos{i}.k``/``pos{i}.v`` (n_super, B, max_seq, KH, hd) in ``cfg.dtype``;
    for an SSM position ``pos{i}.conv`` (n_super, B, k-1, d_inner) in
    ``cfg.dtype`` and ``pos{i}.ssm`` (n_super, B, H, P, N) in float32.

    With a serve ``policy``, this rank's part of the global ``batch``'s
    cache: B / data rows, and under ``kvdim`` its block of head_dim's
    columns (n_super, B/dp, max_seq, KH, hd_loc), the balanced split of
    head_dim where the model axis does not divide it; under ``kvseq`` one
    contiguous block of ceil(max_seq / tp) positions (n_super, B/dp,
    ceil(max_seq / tp), KH, hd).  Where tp does not divide max_seq the
    blocks cover a buffer rounded up to a multiple of tp (GSPMD pads the
    reference's the same way); decode masks every position past
    ``cache_len``, the padding included.  KH is every K/V head under
    either layout.  An SSM position's states are this rank's SSM heads
    (``ssm.local_ssm_heads``) and their channels, whatever the layout:
    conv (n_super, B/dp, k-1, H_loc x P), ssm (n_super, B/dp, H_loc, P,
    N)."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    n_super = cfg.num_layers // cfg.block_period
    hd = cfg.resolved_head_dim
    d_inner, ssm_heads = cfg.d_inner, cfg.ssm_heads
    if policy is not None:
        check_serve_policy(cfg, policy)
        dp, tp = policy.dp_size, policy.model_size
        me = _model_index(policy)
        ssm_heads = head_block(ssm_heads, tp, me)[1]
        d_inner = ssm_heads * cfg.ssm_head_dim
        if batch % dp:
            raise ValueError(f"batch {batch} not divisible by the data "
                             f"axis's size {dp}")
        batch //= dp
        if policy.kv_layout == "kvdim":
            hd = balanced_split(hd, tp)[me]
        else:
            max_seq = -(-max_seq // tp)
    cache = {}
    for i in range(cfg.block_period):
        if cfg.mixer_kind(i) == "attn":
            shape = (n_super, batch, max_seq, cfg.num_kv_heads, hd)
            for name in ("k", "v"):
                cache[f"pos{i}.{name}"] = torch.zeros(shape, dtype=dtype,
                                                      device=device)
        else:
            cache[f"pos{i}.conv"] = torch.zeros(
                (n_super, batch, cfg.conv_kernel - 1, d_inner),
                dtype=dtype, device=device)
            cache[f"pos{i}.ssm"] = torch.zeros(
                (n_super, batch, ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=device)
    return cache


# ---------------------------------------------------------------------------
# Sharded serving: this rank's parameters.  Heads and d_ff split over the
# model axis as the TP train path splits them (column blocks of wq, wk, wv,
# w_up, w_gate; row blocks of wo, w_down; the sublayer norms' weights with
# the feature-sharded residual); an SSM mixer's as the reference's
# ``param_spec`` (``repro/sharding/policy.py:315-319``: column blocks of
# in_z, in_x, in_dt and conv_w, blocks of the per-head and per-channel
# vectors, row blocks of out_proj; in_B and in_C whole); an MoE FFN's
# experts on their E dim (the logical "experts"), the router whole and
# the shared experts as the MLP; wk and wv whole where the model axis does
# not divide the K/V heads; the embedding, final norm and head whole.
# Where the axis does not divide a width, its blocks are the paper's
# balanced split, aligned to heads: wq's columns and wo's rows by the
# query heads (``attention.head_block``), the SSM leaves by the SSM heads
# (``ssm.ssm_block_of``), d_model and d_ff by ``balanced_split``.
# ---------------------------------------------------------------------------

_SERVE_SPLIT = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_up": 2,
                "w_gate": 2, "w_down": 1, "norm_mixer": 1, "norm_ffn": 1,
                "in_z": 2, "in_x": 2, "in_dt": 2, "conv_w": 2, "a_log": 1,
                "d_skip": 1, "dt_bias": 1, "ssm_norm": 1, "out_proj": 1,
                "we_up": 1, "we_gate": 1, "we_down": 1}
# leaves init_params draws in fp32 whatever the model's dtype, and how
_FP32_INIT = {"a_log": "log_uniform", "d_skip": "ones", "dt_bias": "zeros",
              "ssm_norm": "ones", "router": "normal"}


def _serve_block(cfg, key: str, shape: tuple, tp: int, index: int):
    """``(dim, start, length)`` of rank ``index``'s block of leaf ``key``
    (global ``shape``, its leading dim the stack) for sharded serving over
    a model axis of size ``tp``; None where the leaf is whole.  wq's
    columns and wo's rows are the rank's query heads
    (``attention.head_block``), an SSM leaf's block its SSM heads or their
    channels (``ssm.ssm_block_of``); every other split leaf is cut by the
    balanced split of its dim (equal blocks where tp divides it)."""
    if not key.startswith("blocks."):
        return None
    name = key.rsplit(".", 1)[-1]
    dim = _SERVE_SPLIT.get(name)
    if dim is None or (name in ("wk", "wv") and cfg.num_kv_heads % tp):
        return None
    if name in ("wq", "wo"):
        hd = cfg.resolved_head_dim
        first, n = head_block(cfg.num_heads, tp, index)
        return dim, first * hd, n * hd
    if ".ssm." in key:
        d, first, n = ssm_block_of(cfg, name, tp, index)
        return d + 1, first, n
    offs = shard_offsets(shape[dim], tp)
    return dim, offs[index], offs[index + 1] - offs[index]


def _model_index(policy) -> int:
    """This rank's position along ``policy``'s model axis."""
    with prim.use_mesh(policy.mesh):
        return prim.axis_index(policy.model_axis)


def shard_params(cfg, params, policy) -> dict:
    """This rank's shards of the GLOBAL ``params`` (``init_params``'s tree,
    the same on every rank) for sharded serving under ``policy``: each
    ``blocks.*`` leaf's block along the dim ``_serve_block`` names, a
    fresh contiguous copy; a whole leaf is the leaf itself."""
    check_serve_policy(cfg, policy)
    tp, me = policy.model_size, _model_index(policy)
    out = {}
    with torch.no_grad():
        for k, v in params.items():
            blk = _serve_block(cfg, k, tuple(v.shape), tp, me)
            out[k] = v if blk is None else v.narrow(*blk).clone(
                memory_format=torch.contiguous_format)
    return out


def init_rank_params(cfg, policy, seed: int, device=None, dtype=None) -> dict:
    """This rank's shards for sharded serving, drawn on ``device`` alone
    (a model too large for one card or host is never built whole), at
    ``init_params``'s distributions.  Two explicit ``torch.Generator``s on
    ``device``: one seeded ``seed`` for the whole leaves, the same on every
    rank, and one seeded ``seed + 1 + model index`` for the split ones, so
    the data replicas hold the same shards.  The values are not
    ``init_params(seed)``'s cut (that would need the whole draw).  The
    leaves and their global shapes are ``init_params``' own
    (``launch.specs.param_specs``, nothing allocated), and so are their
    distributions: in fp32 the norm weights, ``ssm_norm`` and ``d_skip``
    ones, ``dt_bias`` zeros, ``a_log`` uniform in [0, log 16) (A
    log-uniform in [1, 16)) and the router N(0, 1/d); every other leaf
    N(0, 1/d_in) in ``dtype``, d_in the global leaf's second-last dim
    (``conv_w``'s is its kernel width)."""
    from repro_torch.launch.specs import param_specs
    check_serve_policy(cfg, policy)
    device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    tp, me = policy.model_size, _model_index(policy)
    whole = torch.Generator(device=device).manual_seed(seed)
    mine = torch.Generator(device=device).manual_seed(seed + 1 + me)
    out = {}
    for key, like in param_specs(cfg).items():
        shape = tuple(like.shape)
        blk = _serve_block(cfg, key, shape, tp, me)
        if blk is not None:
            dim, _, n = blk
            shape = shape[:dim] + (n,) + shape[dim + 1:]
        out[key] = _draw_block(key, tuple(like.shape), shape,
                               whole if blk is None else mine, dtype)
    return out


def _draw_block(key, global_shape, shape, gen, dtype):
    """A block of ``shape`` of leaf ``key`` drawn from ``gen`` (on its
    device) at ``init_params``' distribution of the GLOBAL leaf: unit fp32
    norm weights, ``ssm_norm`` and ``d_skip`` ones, ``dt_bias`` zeros,
    ``a_log`` uniform in [0, log 16), the router N(0, 1/d) in fp32, every
    other leaf N(0, 1/d_in) in ``dtype`` (d_in the global leaf's second
    last dim)."""
    device = gen.device
    name = key.rsplit(".", 1)[-1]
    how = "ones" if name.startswith("norm") else _FP32_INIT.get(name)
    if how in ("ones", "zeros"):
        return torch.full(shape, float(how == "ones"), dtype=torch.float32,
                          device=device)
    if how == "log_uniform":
        return torch.rand(shape, generator=gen, device=device) * math.log(16.0)
    stacked = key.startswith("blocks.")
    return normal_init(shape[1:] if stacked else shape,
                       1 / math.sqrt(global_shape[-2]),
                       torch.float32 if how == "normal" else dtype, gen,
                       stacked=shape[0] if stacked else 0)


# ---------------------------------------------------------------------------
# The policy train program (the reference's GSPMD ``build_train_step`` under
# ``Policy(mesh)``: ZeRO-3 over the fsdp axes, tensor and sequence
# parallelism over ``model``), one rank of it.  Each leaf is this rank's
# block under the reference's ``param_spec`` rules
# (``repro/sharding/policy.py:644-697``): ``fsdp`` -> data (and pod under
# ``fsdp_over_pod``), heads / ff / vocab / model / experts -> model, a dim
# its axes do not divide left whole.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _param_shapes(cfg) -> tuple:
    """``((name, global shape), ...)`` of ``cfg``'s parameters, from
    ``launch.specs.param_specs`` (nothing allocated), once a config."""
    from repro_torch.launch.specs import param_specs
    return tuple((k, tuple(v.shape)) for k, v in param_specs(cfg).items())


def train_param_specs(cfg, policy) -> dict:
    """``{name: PartitionSpec}`` of every parameter of ``cfg`` under
    ``policy``'s ``param_spec`` (the global shapes of
    ``launch.specs.param_specs``; nothing allocated).  A stacked leaf's
    spec leads with None, its superblock dim."""
    return {k: policy.param_spec(k, shape) for k, shape in _param_shapes(cfg)}


def fsdp_axes(policy) -> tuple:
    """The mesh axes ZeRO-3 shards parameters over (``phys("fsdp")``):
    ``()``, ``("data",)`` or ``("pod", "data")``."""
    ax = policy.phys("fsdp")
    return () if ax is None else (ax if isinstance(ax, tuple) else (ax,))


def shard_train_params(cfg, params, policy) -> dict:
    """This rank's blocks of the GLOBAL ``params`` (``init_params``'s
    tree, the same on every rank) for the policy train program: each leaf
    cut under ``train_param_specs``, always a fresh copy (the optimizer
    updates the state in place, and must not write into ``params``)."""
    check_train_policy(cfg, policy)
    blocks = local_blocks(train_param_specs(cfg, policy), params, policy)
    return {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in blocks.items()}


def init_rank_train_params(cfg, policy, seed: int, device=None,
                           dtype=None) -> dict:
    """This rank's blocks for the policy train program, drawn on
    ``device`` alone (no host or card holds the whole model), at
    ``init_params``' distributions (``init_rank_params``'s rules: unit
    fp32 norms, the SSM vectors' fixed draws, N(0, 1/d_in) of the GLOBAL
    leaf elsewhere).  Every block of a leaf has its own
    ``torch.Generator``, seeded from ``seed``, the leaf and the block's
    position on the axes that split it, so the ranks that hold the same
    block draw the same values.  The values are not ``init_params(seed)``'s
    cut."""
    check_train_policy(cfg, policy)
    device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    with prim.use_mesh(policy.mesh):
        index = {a: prim.axis_index(a) for a in policy.axis_names}
    out = {}
    for i, (key, global_shape) in enumerate(_param_shapes(cfg)):
        shape, block = list(global_shape), 0
        for d, entry in enumerate(policy.param_spec(key, global_shape)):
            for a in spec_axes(entry):
                shape[d] //= policy.axis_size(a)
                block = block * policy.axis_size(a) + index[a]
        gen = torch.Generator(device=device).manual_seed(
            (seed * 1_000_003 + i * 65_537 + block) % 2 ** 63)
        out[key] = _draw_block(key, global_shape, tuple(shape), gen, dtype)
    return out


def _vocab_split(specs, cfg, policy) -> bool:
    """Whether the model axis splits the vocabulary: the logits are then
    this rank's vocabulary block (the reference's ``constrain(logits,
    "batch", "ctx", "vocab")``)."""
    head = "embed" if cfg.tie_embeddings else "lm_head"
    return spec_names(specs[head], 0 if cfg.tie_embeddings else 1,
                      policy.model_axis)


def _forward_sp(params, batch, cfg, policy):
    """``forward`` in train mode under a ``seq_shard`` policy: one rank of
    the policy train program (module section above).

    ``params``: this rank's blocks (``shard_train_params``,
    ``init_rank_train_params``); ``batch``: this rank's rows of the global
    batch, ``{"tokens": (B/dp, S)}`` or ``{"embeds": (B/dp, S, d)}``.  The
    residual is (B/dp, S_loc, d) between sublayers, S_loc this rank's
    block of the balanced split of S (S/tp where the axis divides it).
    The embedding lookup is vocab-parallel where the model axis splits the
    vocabulary: rows outside this rank's block are masked and the partial
    rows reduce-scattered onto the sequence shard, so ``embed`` gets its
    gradient once.  Each superblock runs under ``torch.utils.checkpoint``
    when ``cfg.remat`` is set, its weight gathers inside: autograd keeps
    only the residual a superblock, and the backward gathers again.  The
    final norm runs on the sequence shard; the head (``lm_head``, or
    ``embed``ᵀ when tied) is column-parallel over the vocabulary.  Returns
    (logits (B/dp, S, V/tp) — V whole where the vocabulary is not split —
    None, aux)."""
    from torch.utils.checkpoint import checkpoint
    check_train_policy(cfg, policy)
    specs = train_param_specs(cfg, policy)
    ax, fs = policy.model_axis, fsdp_axes(policy)
    dtype = DTYPES[cfg.dtype]
    with region(policy):
        vocab = _vocab_split(specs, cfg, policy)
        if "embeds" in batch:
            x = seq_scatter(batch["embeds"].to(dtype), ax, False)
            B, S = batch["embeds"].shape[:2]
        else:
            tokens = batch["tokens"]
            B, S = tokens.shape
            table = gather_block(params["embed"], specs["embed"], fs)
            if vocab:
                lo = prim.axis_index(ax) * table.shape[0]
                local = tokens - lo
                keep = (local >= 0) & (local < table.shape[0])
                rows = embed_lookup(table, torch.where(keep, local, 0))
                x = seq_scatter(rows * keep[..., None].to(rows.dtype), ax,
                                True)
            else:
                x = seq_scatter(embed_lookup(table, tokens), ax, False)
            x = x.to(dtype)
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
        layers = {k: v.unbind(0) for k, v in subtree(params, "blocks").items()}
        blk_specs = {k: P(*tuple(v)[1:])
                     for k, v in subtree(specs, "blocks").items()}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def run(x, *leaves):
            p_blk = dict(zip(layers, leaves))
            return superblock_apply_sp(p_blk, blk_specs, x, cfg, policy,
                                       positions=positions, fsdp_axes=fs)

        for s in range(cfg.num_layers // cfg.block_period):
            leaves = [v[s] for v in layers.values()]
            if cfg.remat:
                x, aux_s = checkpoint(run, x, *leaves, use_reentrant=False)
            else:
                x, aux_s = run(x, *leaves)
            aux = aux + aux_s
        x = seq_gather(rmsnorm(x, params["norm_final"]), ax, S)
        if cfg.tie_embeddings:
            logits = x @ gather_block(params["embed"], specs["embed"], fs).T
        else:
            logits = x @ gather_block(params["lm_head"], specs["lm_head"], fs)
    return logits, None, aux


def forward(params, batch, cfg, *, mode="train", cache=None, policy=None):
    """Returns (logits, new_cache, aux_loss).

    batch: ``{"tokens": (B, S) integer}``, or ``{"embeds": (B, S, d)}``
    for the stub frontends (cast to ``cfg.dtype``, no lookup); decode
    additionally takes ``{"cache_len": int}`` and S == 1.  In prefill
    ``new_cache`` holds the prompt's K/V stacked ``(n_super, B, S, KH,
    hd)`` and the conv and SSM states after the prompt, stacked
    ``(n_super, ...)``; in decode it is ``cache``, every leaf updated in
    place.  ``aux_loss`` is the MoE load-balance loss summed over the
    layers (fp32; 0 without MoE).

    ``policy`` in train mode with ``fsdp`` or ``seq_shard`` on and no
    ctx, ep or pipe axis (``blocks.is_sp_policy``; ``Policy(mesh)``): one
    rank of the policy train program (``_forward_sp``): ``params`` are
    this rank's blocks and ``batch`` its rows, and the logits come back
    as its rows' vocabulary block.

    Any other ``policy`` in train mode (every rank of its mesh calling
    with the same global batch): each sublayer runs as
    ``sublayer_apply`` runs it with a policy.  Under a live ctx axis the
    regions cut the sequence and the global positions together, and
    attention rings over the axis.

    ``policy`` in prefill and decode is sharded serving over its (data,
    model) mesh (``blocks.check_serve_policy``), every rank calling
    together: ``params`` are this rank's shards (``shard_params``,
    ``init_rank_params``), ``batch`` this rank's rows, ``cache`` this
    rank's part of ``init_cache(..., policy=)``, which prefill fills in
    place as decode does; the logits are this rank's rows.  The residual
    runs feature-sharded over the model axis, as the TP train sublayer's
    (the balanced split of d_model where the axis does not divide it),
    and is gathered whole for the final norm and the head.
    """
    if mode == "train" and is_sp_policy(policy):
        return _forward_sp(params, batch, cfg, policy)
    serving = policy is not None and mode != "train"
    if serving:
        check_serve_policy(cfg, policy)
        if cache is None:
            raise ValueError("sharded prefill writes into a cache: pass "
                             "init_cache(..., policy=policy)")
    if "embeds" in batch:
        x = batch["embeds"]
    else:
        x = embed_lookup(params["embed"], batch["tokens"])
    x = x.to(DTYPES[cfg.dtype])
    B, S = x.shape[:2]
    cache_len = int(batch.get("cache_len", 0))
    if mode == "decode":
        positions = torch.full((B, 1), cache_len, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)

    with region(policy) if serving else contextlib.nullcontext():
        if serving:
            x = L.shard_slice(x, policy.model_axis, 2)
        # unbind, not v[s]: in train mode each stacked leaf's grad is then
        # one stack of the per-superblock grads, not n_super full-size
        # zero-padded grads summed
        layers = {k: v.unbind(0) for k, v in subtree(params, "blocks").items()}
        n_super = cfg.num_layers // cfg.block_period
        kv_per_block = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(n_super):
            p_blk = {k: v[s] for k, v in layers.items()}
            x, kv, aux_s = superblock_apply(p_blk, x, cfg, positions=positions,
                                            mode=mode, cache=cache, index=s,
                                            cache_len=cache_len, policy=policy)
            kv_per_block.append(kv)
            aux = aux + aux_s
        if serving:
            x = prim.all_gather(x, policy.model_axis, 2, balanced_split(
                cfg.d_model, policy.model_size))

    if mode == "prefill" and not serving:
        new_cache = {k: torch.stack([kv[k] for kv in kv_per_block])
                     for k in kv_per_block[0]}
    else:
        new_cache = cache
    x = rmsnorm(x, params["norm_final"])
    head = params.get("lm_head")
    logits = x @ (params["embed"].T if head is None else head)
    return logits, new_cache, aux
