"""Shape stand-ins for every model input and state tree (mirrors
``repro/launch/specs.py``): tensors on the ``meta`` device where the
reference returns ``ShapeDtypeStruct``s, so nothing is allocated.  The
assignment helpers are pure Python, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, ModelConfig
from repro_torch.core.partition import balanced_split
from repro_torch.models.model import DTYPES, init_cache, init_params

_INT = torch.int32


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (a torch dtype or a
    config's dtype name)."""
    return torch.empty(shape, dtype=DTYPES.get(dtype, dtype), device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Model-input specs for one shape cell.

    train:   {tokens|embeds, labels}
    prefill: {tokens|embeds}
    decode:  {tokens, cache_len} (+ cache specs via cache_specs()).
    """
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    stub = cfg.frontend != "none"
    if cell.kind == "train":
        batch = ({"embeds": sds((B, S, cfg.d_model), cfg.dtype)} if stub
                 else {"tokens": sds((B, S), _INT)})
        batch["labels"] = sds((B, S), _INT)
        return batch
    if cell.kind == "prefill":
        return ({"embeds": sds((B, S, cfg.d_model), cfg.dtype)} if stub
                else {"tokens": sds((B, S), _INT)})
    # decode: one new token against a seq_len-deep cache
    return {"tokens": sds((B, 1), _INT), "cache_len": sds((), _INT)}


def stage_assignment(cfg: ModelConfig, num_stages: int) -> list[range]:
    """Per-stage layer ranges for a ``num_stages`` pipeline cut (a planning
    and reporting helper).

    Stages own contiguous runs of whole superblocks (balanced ceil-first
    split), so the result may be NON-uniform, e.g. 4 superblocks over 3
    stages is [2, 1, 1].  The executor (core/pipeline.py) needs uniform
    stages: ``models.to_pipeline_params`` raises for exactly the cuts this
    function reports as unbalanced.
    """
    n_super = cfg.num_layers // cfg.block_period
    out, lo = [], 0
    for sz in balanced_split(n_super, num_stages):
        out.append(range(lo * cfg.block_period, (lo + sz) * cfg.block_period))
        lo += sz
    return out


def pipeline_input_specs(cfg: ModelConfig, shape_name: str,
                         num_microbatches: int) -> tuple[dict, torch.Tensor]:
    """Microbatched (xs, labels) specs for the pipeline executor: the train
    shape cell re-cut to a leading microbatch dim (M, B/M, S)."""
    cell = SHAPES[shape_name]
    if cell.kind != "train":
        raise ValueError(f"pipeline specs need a train cell, got {cell.kind}")
    B, S = cell.global_batch, cell.seq_len
    if B % num_microbatches:
        raise ValueError(f"global batch {B} not divisible by "
                         f"num_microbatches={num_microbatches}")
    mb = B // num_microbatches
    return ({"tokens": sds((num_microbatches, mb, S), _INT)},
            sds((num_microbatches, mb, S), _INT))


def replica_assignment(global_batch: int, dp: int,
                       num_microbatches: int) -> list[range]:
    """Per-replica row ranges of each microbatch under the hybrid cut: the
    global batch is cut into ``num_microbatches`` microbatches of ``B/M``
    rows, then each is scattered over the ``dp`` replicas
    (``BatchScatter``): replica r owns rows ``[r*b, (r+1)*b)`` of EVERY
    microbatch, ``b = B/(M*dp)``."""
    if global_batch % (num_microbatches * dp):
        raise ValueError(
            f"global batch {global_batch} not divisible by num_microbatches "
            f"x dp = {num_microbatches} x {dp}")
    b = global_batch // (num_microbatches * dp)
    return [range(r * b, (r + 1) * b) for r in range(dp)]


def context_assignment(seq_len: int, cp: int) -> list[range]:
    """Per-ctx-rank position ranges under context parallelism: rank c owns
    the CONTIGUOUS rows ``[c*S/cp, (c+1)*S/cp)`` of every microbatch."""
    if seq_len % cp:
        raise ValueError(
            f"sequence length {seq_len} not divisible by cp={cp} — a "
            f"clamped shard would silently drop the trailing positions")
    s = seq_len // cp
    return [range(c * s, (c + 1) * s) for c in range(cp)]


def expert_assignment(num_experts: int, ep: int) -> list[range]:
    """Per-ep-rank expert ranges under expert parallelism: rank e owns the
    CONTIGUOUS experts ``[e*E/ep, (e+1)*E/ep)``."""
    if num_experts % ep:
        raise ValueError(
            f"num_experts {num_experts} not divisible by ep={ep} — a "
            f"clamped shard would silently drop the trailing experts")
    e = num_experts // ep
    return [range(r * e, (r + 1) * e) for r in range(ep)]


def hybrid_input_specs(cfg: ModelConfig, shape_name: str,
                       num_microbatches: int, dp: int,
                       cp: int = 1, ep: int = 1) -> tuple[dict, torch.Tensor]:
    """Microbatched (xs, labels) specs for the hybrid executor: the SAME
    host-side (M, B/M, S) cut as the pipeline (the per-replica restriction
    happens at the region boundary), plus the B % (M*dp*ep), S % cp and
    E % ep divisibility checks the train step enforces."""
    cell = SHAPES[shape_name]
    if cell.kind != "train":
        raise ValueError(f"hybrid specs need a train cell, got {cell.kind}")
    replica_assignment(cell.global_batch, dp * ep, num_microbatches)
    context_assignment(cell.seq_len, cp)
    if ep > 1:
        expert_assignment(cfg.num_experts or 0, ep)
    return pipeline_input_specs(cfg, shape_name, num_microbatches)


def _as_meta(tree: dict) -> dict:
    return {k: sds(v.shape, v.dtype) for k, v in tree.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """Parameter specs from the real initializer run on fake tensors (no
    allocation), as the reference's ``eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = init_params(cfg, torch.Generator(), "cpu")
    return _as_meta(params)


def cache_specs(cfg: ModelConfig, shape_name: str) -> dict:
    cell = SHAPES[shape_name]
    return init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")
