"""Mixture-of-Experts: dispatch/combine as AllToAll adjoints on the ep axis
(mirrors ``repro/models/moe.py``).

The token dispatch/combine is the paper's generalized all-to-all (§3), the
``AllToAll`` linop: a block permutation repartitioning the dispatch buffer
from token-slot-major ``(E, C, d)`` to expert-major ``(E/ep, C*ep, d)``
over the ``ep`` mesh axis; the combine is its registered adjoint, the
reverse all-to-all.  Capacity-factor slot assignment is the
``CapacityRestrict`` operator (``core/linop.py``): dispatch restricts the
scatter buffer onto its first ``E*C`` slots (over-capacity tokens land in
the dropped tail), and the combine applies its adjoint, the zero-padded
embedding, so dropped tokens receive exactly zero output and zero
cotangent by the algebra, not by a mask.  See DESIGN §8.

Axis resolution: ``Policy.active_ep_axis`` when the mesh carries a live
``ep`` axis, else the EP-over-model overload (``policy.model_axis``) on a
(data, model) mesh.  Expert weights shard their E dim over the resolved
axis (``param_spec``'s logical "experts"); with FSDP on, the hidden dims
are also sharded over data and gathered on use (the paper's broadcast B,
whose gradient reduce-scatter is the adjoint R, Eq. 9).

Two region styles serve the same math: ``moe_apply`` opens its own
``dist_jit`` region (the standalone sub-layer), while ``moe_stage_body``
is the body-only form the pipeline executor's region calls from
``models/blocks.py``.  Dispatch is sort-based with a static per-rank
capacity (GShard semantics): ``index_add`` scatters, gathers, the stable
argsort (slot order decides which tokens drop, so the sort must be
stable).  Inside a region a replicated value's cotangent is a per-rank
contribution (README, "Cotangent convention"), so the statistics' means
over ``stat_axes`` are ``all_reduce`` (psum both ways) over the axis size,
as the reference's ``pmean``.  The expert products (``ecd,edh->ech``) are
``torch.bmm``: the reference computes them outside any Pallas kernel, so
MoE adds no kernel.  ``num_experts % ep != 0`` raises before anything
runs instead of silently mis-splitting.

Sharded serving (``moe_serve_body``, prefill and decode under a serve
policy) splits the experts over the model axis, the EP-over-model overload
of ``param_spec``'s logical "experts", without the all-to-all: the tokens
are already replicated over ``model`` there, so every rank routes them
all with the whole router (the same plan and capacity on every model
rank, and the reference's: over this data replica's tokens) and runs only
its own experts; the partial outputs meet in one reduce-scatter, the
paper's sum-reduce.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.core import primitives as prim
from repro_torch.core.compile import dist_jit
from repro_torch.core.linop import AllToAll, CapacityRestrict
from repro_torch.core.linop import PartitionSpec as P
from repro_torch.core.partition import balanced_split

from .common import (dense_init, mlp_apply, mlp_apply_sp, mlp_init,
                     normal_init, seq_gather, seq_scatter, spec_names,
                     subtree)

EXPERT_LEAVES = ("we_up", "we_gate", "we_down")


def moe_init(cfg, dtype, generator, stacked: int = 0) -> dict:
    """Same leaves, shapes and distributions as the reference
    (``moe.py:53-68``): an fp32 router ``(d, E)``, expert weights ``(E, d,
    h)`` / ``(E, h, d)``, and the shared experts' SwiGLU MLP under
    ``shared.``; each leaf stacked ``(stacked, ...)`` when asked."""
    d, E = cfg.d_model, cfg.num_experts
    h = cfg.moe_d_ff or cfg.d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h)
    p = {
        "router": dense_init(d, E, torch.float32, generator, stacked),
        "we_up": normal_init((E, d, h), s_in, dtype, generator,
                             stacked=stacked),
        "we_gate": normal_init((E, d, h), s_in, dtype, generator,
                               stacked=stacked),
        "we_down": normal_init((E, h, d), s_out, dtype, generator,
                               stacked=stacked),
    }
    if cfg.num_shared_experts:
        p.update({f"shared.{k}": v for k, v in mlp_init(
            d, h * cfg.num_shared_experts, "swiglu", dtype, generator,
            stacked).items()})
    return p


def _check_expert_split(cfg, ep: int, ep_axis):
    """The E dim must split evenly over the ep axis: a clamped split would
    silently drop the trailing experts."""
    if cfg.num_experts % ep:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by ep={ep} over "
            f"axis {ep_axis!r} — a clamped split would silently drop the "
            f"trailing experts (see launch/specs.py::expert_assignment)")


def expert_ffn(disp, wu, wg, wd):
    """The experts' SwiGLU on their slots: (E, C, d) -> (E, C, d), the
    reference's ``ecd,edh->ech`` products as batched matmuls."""
    h = torch.bmm(disp, wu)
    g = torch.bmm(disp, wg)
    return torch.bmm(F.silu(g) * h, wd)


def _pmean(x, axes):
    """The reference's ``pmean`` over ``axes`` inside a region: the sum is
    ``all_reduce`` (psum both ways), then the mean.  Axes of size 1 are
    the identity."""
    for ax in axes:
        n = prim.axis_size(ax)
        if n > 1:
            x = prim.all_reduce(x, ax) / n
    return x


def dispatch_plan(gate_idx, E: int, cap: int):
    """The sort-based slot assignment of ``_dispatch_combine_local``:
    ``(order, slot, keep, tok, counts)`` for top-k choices ``gate_idx``
    (T, k).  Choices are sorted by expert, stably, so within an expert
    earlier tokens (and a token's first choice) take the first slots; the
    ``pos``-th choice of expert ``e`` lands in slot ``e*cap + pos`` if
    ``pos < cap``, else in the drop slot ``E*cap``."""
    T, k = gate_idx.shape
    flat_e = gate_idx.reshape(-1)                       # (T*k,)
    # counted by a scatter-add, as the reference: no host sync (bincount
    # reads its input's max), so a decode step can be a CUDA graph
    counts = torch.zeros(E, device=flat_e.device).index_add_(
        0, flat_e, torch.ones(T * k, device=flat_e.device))
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = (torch.arange(T * k, device=flat_e.device)
           - starts[sorted_e].long())
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, E * cap))
    return order, slot, keep, order // k, counts


def _dispatch_combine_local(x, router_w, cfg, expert_fn, stat_axes=()):
    """Per-rank routing: top-k -> sort -> capacity buffer -> expert_fn ->
    combine.  x: (T, d) local tokens.  expert_fn: (E, C, d) -> (E, C, d)
    (may repartition E over the ep axis inside).  Returns (y, aux).

    The scatter buffer has ``E*cap + 1`` slots; slot ``E*cap`` is the
    dropped-token tail.  ``CapacityRestrict`` cuts it off before the
    experts run, and its adjoint (the zero-padded embedding) restores the
    slot layout on the way back: dropped tokens read zeros and their
    cotangents vanish in the pad.

    ``stat_axes``: mesh axes the tokens are sharded over (data/ctx/ep in
    the hybrid executor).  When given, the load-balance statistics (expert
    counts, mean router probabilities) are reduced over them, so ``aux``
    is the global-microbatch statistic on every rank.  Empty keeps the
    local statistic.
    """
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token

    logits = x.float() @ router_w                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, gate_idx = torch.topk(probs, k, dim=-1)       # (T, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    cap = int(math.ceil(T * k / E * cfg.capacity_factor))
    order, slot, keep, tok, counts = dispatch_plan(gate_idx, E, cap)

    # load-balance auxiliary loss (Switch/GShard form)
    counts_g, probs_g, T_g = counts, probs.mean(dim=0), T
    if stat_axes:
        counts_g = counts.clone()
        prim.psum_([counts_g], stat_axes)
        probs_g = _pmean(probs_g, stat_axes)
        for ax in stat_axes:
            T_g = T_g * prim.axis_size(ax)
    aux = E * torch.sum((counts_g / (T_g * k)) * probs_g)

    # P_cap: keep the E*cap capacity slots, drop the over-capacity tail.
    cap_op = CapacityRestrict(0, E * cap, E * cap + 1)
    kept = keep[:, None]

    buf = x.new_zeros((E * cap + 1, d)).index_add(
        0, slot, torch.where(kept, x[tok], 0))
    out = expert_fn(cap_op(buf).reshape(E, cap, d))     # (E, cap, d)

    # P_cap* — the zero-padded embedding: dropped slots read zeros.
    out_pad = cap_op.T(out.reshape(E * cap, d))
    contrib = out_pad[slot] * gate.reshape(-1)[order][:, None]
    y = x.new_zeros((T, d)).index_add(
        0, tok, torch.where(kept, contrib, 0).to(x.dtype))
    return y, aux


def moe_block_fn(x, p, cfg, *, ep_axis, fsdp_axes, fsdp: bool, all_axes):
    """Region body of the standalone sub-layer (``moe_apply``).
    x: (B_loc, S_loc, d) local tokens; p: the router and this rank's
    expert blocks."""
    Bl, Sl, d = x.shape
    ep = prim.axis_size(ep_axis)
    _check_expert_split(cfg, ep, ep_axis)
    dispatch = AllToAll(ep_axis, 0, 1)

    def expert_fn(disp):  # (E, C, d) local slots for ALL experts
        # the paper's generalized all-to-all: token-slot-major ->
        # expert-major, (E, C, d) -> (E/ep, C*ep, d)
        if ep > 1:
            disp = dispatch(disp)
        wu, wg, wd = (p[k] for k in EXPERT_LEAVES)
        if fsdp:
            # ZeRO-3 gather = the paper's broadcast B; its adjoint
            # reduce-scatters the grads (R)
            for ax in fsdp_axes:
                wu = prim.all_gather(wu, ax, 1)
                wg = prim.all_gather(wg, ax, 1)
                wd = prim.all_gather(wd, ax, 2)
        out = expert_ffn(disp, wu, wg, wd)
        if ep > 1:
            out = dispatch.T(out)   # combine: the registered adjoint
        return out

    y, aux = _dispatch_combine_local(x.reshape(Bl * Sl, d), p["router"], cfg,
                                     expert_fn)
    # the aux loss averaged over every mesh axis (tokens differ per rank)
    return y.reshape(Bl, Sl, d), _pmean(aux, all_axes)


def moe_stage_body(x, p, cfg, *, ep_axis=None, stat_axes=()):
    """MoE sub-layer body for the pipeline executor's region
    (``models/blocks.py::pipeline_stage_body``).

    x: (B_loc, S_loc, d) local tokens; p: the local moe leaves, the expert
    weights as (E/ep, ...) blocks when ``ep_axis`` is live, whole when not.
    Dispatch and combine ride ``AllToAll(ep_axis, 0, 1)`` and its adjoint
    as in :func:`moe_block_fn`.  ``stat_axes`` (the live token-sharding
    axes: data/ctx/ep) makes the aux loss the global statistic, the same
    on those ranks, which the executor's epilogue sum x 1/(dp*cp*ep) then
    counts once.  Returns (y, aux)."""
    Bl, Sl, d = x.shape
    ep = prim.axis_size(ep_axis) if ep_axis else 1
    _check_expert_split(cfg, ep, ep_axis)
    dispatch = AllToAll(ep_axis, 0, 1) if ep > 1 else None

    def expert_fn(disp):  # (E, C, d) local slots for ALL experts
        if dispatch is not None:
            disp = dispatch(disp)                       # (E/ep, C*ep, d)
        out = expert_ffn(disp, *(p[k] for k in EXPERT_LEAVES))
        return dispatch.T(out) if dispatch is not None else out

    y, aux = _dispatch_combine_local(x.reshape(Bl * Sl, d), p["router"], cfg,
                                     expert_fn, stat_axes=stat_axes)
    y = y.reshape(Bl, Sl, d)
    if cfg.num_shared_experts:
        y = y + mlp_apply(x, subtree(p, "shared"), "swiglu")
    return y, aux


def moe_serve_body(h, p, cfg, policy):
    """The MoE FFN for sharded serving, inside the serving region.

    h: (B_loc, S, d_loc), the normed residual feature-sharded over the
    model axis (the balanced split of d_model); p: the whole router, this
    rank's E/tp experts (a block of the E dim of ``we_up``, ``we_gate``,
    ``we_down``) and its d_ff block of the shared experts' SwiGLU (the
    balanced split where the axis does not divide it).  h is gathered whole once;
    routing, the slot plan and the capacity (over this replica's B_loc x
    S tokens) are the same on every model rank; each rank runs its own
    experts over their capacity slots and combines a partial output in
    which tokens routed elsewhere get zero, adds the shared experts'
    partial, and the partials are reduce-scattered into the residual's
    feature split.  The reference's ``moe_apply`` region dispatches the
    replicated tokens with an ``AllToAll`` on the model axis, which runs
    every expert tp times; both compute the same function up to the
    order of summation.  Returns (B_loc, S, d_loc)."""
    ax = policy.model_axis
    tp = policy.model_size
    _check_expert_split(cfg, tp, ax)
    d_sizes = balanced_split(cfg.d_model, tp)
    x = prim.all_gather(h, ax, 2, d_sizes)
    B, S, d = x.shape
    e_loc = cfg.num_experts // tp
    lo = prim.axis_index(ax) * e_loc
    weights = [p[k] for k in EXPERT_LEAVES]

    def expert_fn(disp):  # (E, C, d): the slots of every expert
        out = torch.zeros_like(disp)
        out[lo:lo + e_loc] = expert_ffn(disp[lo:lo + e_loc], *weights)
        return out

    y, _ = _dispatch_combine_local(x.reshape(B * S, d), p["router"], cfg,
                                   expert_fn)
    y = y.reshape(B, S, d)
    if cfg.num_shared_experts:
        y = y + mlp_apply(x, subtree(p, "shared"), "swiglu")
    return prim.reduce_scatter(y, ax, 2, d_sizes)


def moe_apply_sp(h, p, specs, cfg, policy, fsdp_axes, seq: int):
    """The MoE FFN of the policy train program on this rank
    (``models.forward`` under a policy with ``seq_shard``): the body of the
    reference's ``moe_apply`` region on the tokens this rank holds.

    h: (B/dp, S_loc, d), the normed residual's sequence shard (``seq``
    the global length): the tokens of
    the reference's region boundary ``P(batch, seq, None)``, so routing
    and the capacity are over them, as there.  ``p``: the router (whole),
    this rank's E/tp experts (the EP-over-model overload of "experts")
    with their d_model dim over the fsdp axes, gathered inside
    (``moe_block_fn``), and the shared experts' blocks, run as the dense
    FFN (``mlp_apply_sp``).  The load-balance loss is the mean over every
    mesh axis of each rank's statistic, the reference's.  Where the model
    axis does not divide ``seq``, the reference's boundary leaves the
    sequence whole (its ``fits``), so every model rank routes the whole
    sequence, gathered, and keeps its block of the output.  Returns (y on
    the sequence shard, aux)."""
    ax = policy.model_axis
    fsdp = any(spec_names(specs["we_up"], 1, a) for a in fsdp_axes)
    whole = seq % policy.model_size != 0
    y, aux = moe_block_fn(seq_gather(h, ax, seq) if whole else h,
                          {k: p[k] for k in ("router",) + EXPERT_LEAVES},
                          cfg, ep_axis=ax,
                          fsdp_axes=fsdp_axes if fsdp else (), fsdp=fsdp,
                          all_axes=tuple(policy.axis_names))
    if whole:
        y = seq_scatter(y, ax, False)
    if cfg.num_shared_experts:
        y = y + mlp_apply_sp(h, subtree(p, "shared"), subtree(specs, "shared"),
                             "swiglu", policy, fsdp_axes, seq)
    return y, aux


def moe_apply(x, p, cfg, policy=None):
    """MoE FFN sub-layer.  x: (B, S, d) global.  Returns (y, aux_loss).

    With no policy (or ``explicit_moe`` off) the reference path: every
    expert over its capacity slots on this device.  Otherwise ONE
    ``dist_jit`` region over ``policy.mesh`` (dispatch all-to-all, expert
    GEMMs, combine); x and p are then the global values, the same on every
    rank, and every rank of the mesh calls it."""
    if policy is None or not policy.explicit_moe:
        B, S, d = x.shape
        y, aux = _dispatch_combine_local(
            x.reshape(B * S, d), p["router"], cfg,
            lambda disp: expert_ffn(disp, *(p[k] for k in EXPERT_LEAVES)))
        y = y.reshape(B, S, d)
        if cfg.num_shared_experts:
            y = y + mlp_apply(x, subtree(p, "shared"), "swiglu")
        return y, aux

    B, S, d = x.shape

    def fits(phys, dim):
        if phys is None:
            return None
        names = phys if isinstance(phys, tuple) else (phys,)
        return phys if dim % math.prod(policy.axis_size(a)
                                       for a in names) == 0 else None

    # the dedicated ep axis when live, else the EP-over-model overload, as
    # param_spec's logical "experts"
    ep_axis = policy.active_ep_axis or policy.model_axis
    bp = policy.phys("batch")
    if policy.active_ep_axis:
        # a live ep axis sub-shards the token batch alongside data, as the
        # hybrid executor's Partitioned(None, ("data", "ep"), "ctx")
        bp = ((tuple(bp) if isinstance(bp, tuple) else ((bp,) if bp else ()))
              + (policy.active_ep_axis,))
    x_spec = P(fits(bp, B), fits(policy.phys("seq"), S), None)
    w_specs = {"router": P(None, None)}
    w_specs.update({k: policy.param_spec(k, tuple(p[k].shape))
                    for k in EXPERT_LEAVES})
    p_in = {k: p[k] for k in w_specs}
    fsdp_phys = policy.phys("fsdp")
    fsdp_axes = ((fsdp_phys if isinstance(fsdp_phys, tuple) else (fsdp_phys,))
                 if fsdp_phys else ())
    denom = math.prod(policy.axis_size(a) for a in fsdp_axes)
    fsdp = policy.fsdp and p["we_up"].shape[1] % denom == 0

    body = partial(moe_block_fn, cfg=cfg, ep_axis=ep_axis,
                   fsdp_axes=fsdp_axes, fsdp=fsdp,
                   all_axes=tuple(policy.axis_names))
    y, aux = dist_jit(body, policy, (x_spec, w_specs), (x_spec, P()))(x, p_in)
    if cfg.num_shared_experts:
        # the shared expert: a dense FFN on the global tokens
        y = y + mlp_apply(x, subtree(p, "shared"), "swiglu")
    return y, aux
