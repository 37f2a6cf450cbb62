"""Decoder blocks: (attention | SSD mixer) + (dense MLP | none) sub-layers
(mirrors ``repro/models/blocks.py``).

A *superblock* is one period of the architecture's layer pattern; the
model stacks its parameters on a leading dim.  MoE sub-layers are not
ported yet (ROADMAP Queue 1, "MoE and expert parallelism").
"""

from __future__ import annotations

import torch

from .attention import attention_block, attn_init
from .common import mlp_apply, mlp_init, rmsnorm, subtree
from .ssm import ssm_block, ssm_init


def layer_kinds(cfg, layer: int) -> tuple[str, str]:
    return cfg.mixer_kind(layer), cfg.ffn_kind(layer)


def check_supported(cfg):
    """Raise ``NotImplementedError`` for the families this port lacks."""
    for i in range(cfg.block_period):
        if layer_kinds(cfg, i)[1] == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE FFNs are not ported yet (ROADMAP Queue 1, "
                "\"MoE and expert parallelism\")")


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
    return p


def sublayer_apply(p, x, cfg, layer: int, *, positions, mode, cache=None,
                   index: int = 0, cache_len=None):
    """One decoder layer: x + mixer(norm(x)); x + mlp(norm(x)).

    ``index`` is this superblock's position in the stack (the slice of the
    stacked decode cache it owns).  Returns (x, state): the mixer's prefill
    cache entries (``{"k", "v"}`` or ``{"conv", "ssm"}``), else None.
    """
    mixer, ffn = layer_kinds(cfg, layer)
    h = rmsnorm(x, p["norm_mixer"])
    if mixer == "attn":
        out, kv = attention_block(subtree(p, "attn"), h, cfg,
                                  positions=positions, mode=mode, cache=cache,
                                  index=index, cache_len=cache_len)
    else:
        out, kv = ssm_block(subtree(p, "ssm"), h, cfg, mode=mode, cache=cache,
                            index=index)
    x = x + out
    if ffn != "none":
        h = rmsnorm(x, p["norm_ffn"])
        x = x + mlp_apply(h, subtree(p, "mlp"), cfg.mlp_type)
    return x, kv


def superblock_init(cfg, dtype, generator, stacked: int) -> dict:
    out = {}
    for i in range(cfg.block_period):
        out.update({f"pos{i}.{k}": v for k, v in
                    sublayer_init(cfg, i, dtype, generator, stacked).items()})
    return out


def superblock_apply(p, x, cfg, *, positions, mode, cache=None, index: int = 0,
                     cache_len=None):
    """Apply one superblock (period consecutive layers).

    cache: flat ``{"pos{i}.<leaf>": stacked cache}`` (decode) or None.
    Returns (x, {"pos{i}.<leaf>": this superblock's cache entries}), the
    entries being K/V or the conv and SSM states, filled in prefill only.
    """
    new_kv = {}
    for i in range(cfg.block_period):
        sub_cache = subtree(cache, f"pos{i}") if cache is not None else None
        x, kv = sublayer_apply(subtree(p, f"pos{i}"), x, cfg, i,
                               positions=positions, mode=mode, cache=sub_cache,
                               index=index, cache_len=cache_len)
        if kv is not None:
            new_kv.update({f"pos{i}.{k}": t for k, t in kv.items()})
    return x, new_kv
