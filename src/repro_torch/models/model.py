"""DecoderLM: the decoder-only model (mirrors ``repro/models/model.py``).

Dense and SSM (mamba2) architectures so far; MoE and ``embeds`` frontends
raise ``NotImplementedError`` naming their ROADMAP item.  The superblock
parameters are stacked on a leading dim, as the reference's scan layout
(``model.py:32``), and applied by a Python loop.

Modes:
  train   — full sequence, returns logits
  prefill — full sequence, also returns the KV / conv / SSM caches
  decode  — single token against the caches (updated in place)
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .blocks import check_supported, superblock_apply, superblock_init
from .common import dense_init, rmsnorm, subtree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_params(cfg, generator, device=None, dtype=None) -> dict:
    """Random parameters at ``cfg``'s widths, as ``{name: Tensor}``.

    Same distributions as the reference (``common.py:62-76``): N(0, 1/d_in)
    weights, unit norm weights in fp32.  ``generator``, a ``torch.Generator``
    on ``device``, replaces the JAX key.  ``device`` defaults to ``cuda``
    and raises without a card; ``dtype`` defaults to ``cfg.dtype``.
    """
    check_supported(cfg)
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


def init_cache(cfg, batch: int, max_seq: int, device=None) -> dict:
    """Zeroed decode caches, stacked per superblock as the reference's scan
    layout (``model.py:212-230``): for an attention position
    ``pos{i}.k``/``pos{i}.v`` (n_super, B, max_seq, KH, hd) in ``cfg.dtype``;
    for an SSM position ``pos{i}.conv`` (n_super, B, k-1, d_inner) in
    ``cfg.dtype`` and ``pos{i}.ssm`` (n_super, B, H, P, N) in float32."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    n_super = cfg.num_layers // cfg.block_period
    cache = {}
    for i in range(cfg.block_period):
        if cfg.mixer_kind(i) == "attn":
            shape = (n_super, batch, max_seq, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            for name in ("k", "v"):
                cache[f"pos{i}.{name}"] = torch.zeros(shape, dtype=dtype,
                                                      device=device)
        else:
            cache[f"pos{i}.conv"] = torch.zeros(
                (n_super, batch, cfg.conv_kernel - 1, cfg.d_inner),
                dtype=dtype, device=device)
            cache[f"pos{i}.ssm"] = torch.zeros(
                (n_super, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                 cfg.ssm_state), dtype=torch.float32, device=device)
    return cache


def forward(params, batch, cfg, *, mode="train", cache=None):
    """Returns (logits, new_cache, aux_loss).

    batch: ``{"tokens": (B, S) integer}``; decode additionally takes
    ``{"cache_len": int}`` and S == 1.  In prefill ``new_cache`` holds the
    prompt's K/V stacked ``(n_super, B, S, KH, hd)`` and the conv and SSM
    states after the prompt, stacked ``(n_super, ...)``; in decode it is
    ``cache``, every leaf updated in place.  ``aux_loss`` is 0 (no MoE).
    """
    check_supported(cfg)
    if "embeds" in batch:
        raise NotImplementedError(
            "embeds frontends are not ported yet (ROADMAP Queue 1, "
            "\"Serving, the rest\": the stub frontends)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens].to(DTYPES[cfg.dtype])
    cache_len = int(batch.get("cache_len", 0))
    if mode == "decode":
        positions = torch.full((B, 1), cache_len, device=tokens.device)
    else:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)

    # unbind, not v[s]: in train mode each stacked leaf's grad is then one
    # stack of the per-superblock grads, not n_super full-size zero-padded
    # grads summed
    layers = {k: v.unbind(0) for k, v in subtree(params, "blocks").items()}
    n_super = cfg.num_layers // cfg.block_period
    kv_per_block = []
    for s in range(n_super):
        p_blk = {k: v[s] for k, v in layers.items()}
        x, kv = superblock_apply(p_blk, x, cfg, positions=positions, mode=mode,
                                 cache=cache, index=s, cache_len=cache_len)
        kv_per_block.append(kv)

    if mode == "prefill":
        new_cache = {k: torch.stack([kv[k] for kv in kv_per_block])
                     for k in kv_per_block[0]}
    else:
        new_cache = cache
    x = rmsnorm(x, params["norm_final"])
    head = params.get("lm_head")
    logits = x @ (params["embed"].T if head is None else head)
    return logits, new_cache, torch.zeros((), device=x.device)
