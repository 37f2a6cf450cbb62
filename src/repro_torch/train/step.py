"""Train-step construction: loss, gradient accumulation, optimizer update
(mirrors ``repro/train/step.py``, the single-device ``build_train_step``).

``build_train_step`` returns a ``(state, batch) -> (state, metrics)``
function:

- fp32 softmax cross-entropy over the logits + the weighted MoE
  load-balance loss + z-loss;
- microbatch gradient accumulation (``cfg.grad_accum``), a Python loop into
  an ``accum_dtype`` accumulator where the reference scans;
- optional gradient compression (a bf16 round trip);
- global-norm clipping folded into the optimizer's fp32 cast as ``scale``,
  then the optimizer update, in place (``optim/optimizers.py``);
- the non-finite guard (``resilience/guard.py``): the one-bit flag is read
  on the host before the update, which runs only on a clean step.

Gradients come from ``torch.autograd.grad`` through the model's forward in
train mode, whose kernels (``kernels/ops.py``) recompute their backward
through their plain versions, as the reference's ``custom_vjp``s do.

``build_hybrid_train_step`` (and its dp = 1 face
``build_pipeline_train_step``) is the sibling over the hybrid DP x pipe x
TP mesh: loss and grads come from the scheduled executor of
``core/pipeline.py`` on THIS RANK's blocks (each rank holds only its
stage's leaves and its TP shard), followed by the same clip and update on
those blocks.  Its guard flag is agreed by the executor's one-bit
all-reduce; the host reads it, and every rank takes the same branch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import primitives as prim
from repro_torch.core.compile import local_blocks, region, resolve_parts
from repro_torch.models import forward
from repro_torch.models.common import spec_axes
from repro_torch.models.model import DTYPES
from repro_torch.optim.optimizers import global_norm
from repro_torch.resilience.guard import (HOST_FAULT, apply_guard,
                                          combine_flags, host_flag,
                                          nonfinite_flag)
from repro_torch.sharding import Partitioned


def cross_entropy(logits, labels, z_loss: float = 1e-4, *, vocab_axis=None):
    """Mean token cross-entropy in fp32 (+ z-loss on the partition fn).

    ``vocab_axis`` (inside a region): ``logits`` are this rank's block of
    the vocabulary over that mesh axis, as the reference constrains them
    (``repro/models/model.py:291``).  The max (no gradient: the
    log-sum-exp does not depend on it), the sum of exponentials and the
    label's logit are each all-reduced over the axis, so the whole logits
    never exist on one rank; the result is replicated over the axis."""
    logits = logits.float()
    if vocab_axis is None or prim.axis_size(vocab_axis) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        V = logits.shape[-1]
        m = prim.pmax(logits.detach().amax(dim=-1), vocab_axis)
        lse = m + torch.log(prim.all_reduce(
            torch.exp(logits - m[..., None]).sum(dim=-1), vocab_axis))
        local = labels - prim.axis_index(vocab_axis) * V
        keep = (local >= 0) & (local < V)
        ll = torch.gather(logits, -1,
                          torch.where(keep, local, 0)[..., None])[..., 0]
        ll = prim.all_reduce(torch.where(keep, ll, 0.0), vocab_axis)
    nll = (lse - ll).mean()
    return nll + z_loss * (lse ** 2).mean(), nll


def build_loss_fn(cfg, aux_weight: float = 0.01, policy=None):
    """``policy``: a policy of the policy train program
    (``models.blocks.is_sp_policy``); ``params`` and ``batch`` are then
    this rank's blocks and rows, and the loss (replicated over the model
    axis) is over this rank's rows, the cross-entropy vocab-parallel.
    Call it inside ``region(policy)``."""
    vocab_axis = None
    if policy is not None:
        from repro_torch.models.model import _vocab_split, train_param_specs
        if _vocab_split(train_param_specs(cfg, policy), cfg, policy):
            vocab_axis = policy.model_axis

    def loss_fn(params, batch):
        logits, _, aux = forward(params, batch, cfg, mode="train",
                                 policy=policy)
        loss, nll = cross_entropy(logits, batch["labels"],
                                  vocab_axis=vocab_axis)
        total = loss + aux_weight * aux
        return total, {"nll": nll, "aux": aux}
    return loss_fn


def batch_to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch arrays as tensors on ``device``; integer
    arrays become int64 (the index type of the gather and the loss)."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        out[name] = t.to(device, t.dtype if t.is_floating_point()
                         else torch.long)
    return out


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, {name: grad}) of ``loss_fn(params, batch)``, all
    detached; ``params`` themselves are not marked as requiring grad."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, metrics = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def build_train_step(cfg, optimizer, *, policy=None, aux_weight: float = 0.01,
                     max_grad_norm: float = 1.0, grad_compress: bool = False,
                     accum_dtype=None, nonfinite_guard: bool = True,
                     fault_hook=None, phase_hook=None):
    """``accum_dtype``: name of the microbatch gradient accumulator's dtype
    (default ``cfg.accum_dtype``), used when ``cfg.grad_accum > 1``.

    ``nonfinite_guard`` (default on): when the loss or any gradient is
    non-finite the update does not run: params and moments stay bitwise
    unchanged, ``skipped_steps`` increments, ``step`` still advances.
    ``fault_hook`` (``grads -> grads``) is the injection point for tests.
    The state's params are updated in place on a clean step.

    ``policy`` with ``fsdp`` or ``seq_shard`` on (``Policy(mesh)``, the
    reference's default): the step is one rank of the policy train
    program, ``_build_sp_train_step``, and ``phase_hook(kind)`` is called
    with "forward", "backward" and "optimizer" as each part starts (the
    chip phase's CUDA events); without one, the one-device step below."""
    if phase_hook is not None and policy is None:
        raise ValueError("phase_hook instruments the policy train program")
    if policy is not None:
        from repro_torch.models.blocks import is_sp_policy
        if not is_sp_policy(policy):
            raise ValueError("build_train_step(policy=) runs the policy "
                             "train program: a policy with fsdp or "
                             "seq_shard on and no ctx, ep or pipe axis")
        return _build_sp_train_step(
            cfg, optimizer, policy, aux_weight=aux_weight,
            max_grad_norm=max_grad_norm, grad_compress=grad_compress,
            accum_dtype=accum_dtype, nonfinite_guard=nonfinite_guard,
            fault_hook=fault_hook, phase_hook=phase_hook)
    loss_fn = build_loss_fn(cfg, aux_weight)
    accum = max(cfg.grad_accum, 1)
    accum_dtype = DTYPES[accum_dtype or cfg.accum_dtype]

    def train_step(state, batch):
        params = state["params"]
        batch = batch_to_device(batch, params["embed"].device)
        if accum > 1:
            mbs = {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
                   for k, x in batch.items()}
            loss = torch.zeros((), device=params["embed"].device)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in params.items()}
            mets = []
            for i in range(accum):
                loss_i, met, grads_i = loss_and_grads(
                    loss_fn, params, {k: x[i] for k, x in mbs.items()})
                for k, g in grads_i.items():
                    grads[k] += g.to(accum_dtype)
                loss = loss + loss_i
                mets.append(met)
            loss = loss / accum
            grads = {k: g / accum for k, g in grads.items()}
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)

        if grad_compress:
            # wire-format compression for the DP all-reduce (bf16)
            grads = {k: g.to(torch.bfloat16).float() for k, g in grads.items()}
        if fault_hook is not None:
            grads = fault_hook(grads)

        # fold the clip scale into the optimizer's fp32 cast: no clipped
        # copy of the gradients is made
        gnorm = global_norm(grads)
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        if nonfinite_guard:
            flag = host_flag(nonfinite_flag((loss, grads)))  # the host decides
            new_params, new_opt = params, state["opt"]
            if not flag:
                new_params, new_opt = optimizer.update(
                    grads, state["opt"], params, scale=scale)
            new_state = apply_guard(flag, state, new_params, new_opt)
            metrics["skipped"] = flag
        else:
            new_params, new_opt = optimizer.update(grads, state["opt"],
                                                   params, scale=scale)
            new_state = {"params": new_params, "opt": new_opt,
                         "step": state["step"] + 1}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The policy train program: the reference's GSPMD ``build_train_step`` under
# ``Policy(mesh)`` (ZeRO-3 over the fsdp axes, tensor and sequence
# parallelism over ``model``) as one explicit per-rank program.
# ---------------------------------------------------------------------------

def sp_state_parts(cfg, policy, optimizer=None) -> dict:
    """``{name: PartitionSpec}`` of this program's train state, the
    ``parts`` a checkpoint records and restores each rank's blocks by:
    every parameter's ``train_param_specs`` spec (its moments take it
    too), and for Adafactor the factored statistics' (``<name>.vr`` the
    spec without its last dim, ``<name>.vc`` without its second last,
    ``<name>.v`` of a vector the vector's)."""
    from repro_torch.models.model import train_param_specs
    from repro_torch.optim.optimizers import Adafactor
    specs = train_param_specs(cfg, policy)
    if isinstance(optimizer, Adafactor):
        from repro_torch.core.linop import PartitionSpec as P
        for k, spec in list(specs.items()):
            e = tuple(spec)
            if len(e) >= 2:
                specs[f"{k}.vr"] = P(*e[:-1])
                specs[f"{k}.vc"] = P(*(e[:-2] + e[-1:]))
            else:
                specs[f"{k}.v"] = spec
    return specs


def _sp_layout(cfg, policy):
    """Per leaf: the live mesh axes its spec leaves it whole over (its
    gradient is a per-rank contribution there, summed after the
    backward), 1 / the product of their sizes (its weight in the global
    norm, so every element counts once), and the live axes splitting
    each dim (Adafactor's factored statistics)."""
    from repro_torch.models.model import train_param_specs
    live = [a for a in policy.axis_names if policy.axis_size(a) > 1]
    whole, weights, dims = {}, {}, {}
    for key, spec in train_param_specs(cfg, policy).items():
        named = {a for e in spec for a in spec_axes(e)}
        whole[key] = tuple(a for a in live if a not in named)
        weights[key] = 1.0 / math.prod(policy.axis_size(a)
                                       for a in whole[key])
        dims[key] = tuple(tuple(a for a in spec_axes(e) if a in live)
                          for e in spec)
    return whole, weights, dims


def _sum_contributions(grads, whole):
    """Each gradient summed over the axes its leaf is whole over, in
    place: one all-reduce per (axes, dtype) bucket of leaves."""
    buckets = {}
    for k, g in grads.items():
        if whole[k]:
            buckets.setdefault((whole[k], g.dtype), []).append(k)
    for (axes, _), keys in buckets.items():
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        prim.psum_([flat], axes)
        for k, part in zip(keys, flat.split([grads[k].numel()
                                             for k in keys])):
            grads[k] = part.view_as(grads[k])


def _build_sp_train_step(cfg, optimizer, policy, *, aux_weight,
                         max_grad_norm, grad_compress, accum_dtype,
                         nonfinite_guard, fault_hook, phase_hook):
    """One rank of the policy train program over ``policy.mesh`` ((data,
    model), or (pod, data, model)); every rank calls the step with the
    same GLOBAL batch and cuts its own rows (over ``batch``: pod and
    data).

    ``state["params"]`` holds this rank's blocks (``models.
    shard_train_params`` / ``init_rank_train_params``) and the optimizer
    moments match them.  Each microbatch of ``cfg.grad_accum`` (the
    reference's scan: microbatch i is rows i*B/accum.. of the global
    batch) runs ``forward`` on this rank's rows (``models.model.
    _forward_sp``) and the vocab-parallel cross-entropy.  The loss, the
    same on every rank, seeds each rank's backward with 1 / (mesh size),
    the cotangent convention of a region (``core/compile.py``), so the
    ZeRO-3 gathers' reduce-scatters land the gradient of each block, and
    the gradient of a leaf left whole over an axis is a contribution,
    summed over it after the backward (``_sum_contributions``).  Then the
    global-norm clip (each rank's sum of squares weighted so every
    element counts once, ONE all-reduce over the mesh), the guard's
    one-bit max all-reduce over the mesh (``fault=True`` sends
    ``HOST_FAULT``, as ``build_hybrid_train_step``), and the optimizer
    update of this rank's blocks in place (Adafactor's factored
    statistics summed over the axes that split their dims).  Raises
    ``ValueError`` when the batch does not divide by grad_accum x the data
    axes' size (a sequence the model axis does not divide is cut by the
    balanced split)."""
    from repro_torch.models.blocks import check_train_policy
    from repro_torch.optim.optimizers import Adafactor
    check_train_policy(cfg, policy)
    loss_fn = build_loss_fn(cfg, aux_weight, policy=policy)
    accum = max(cfg.grad_accum, 1)
    accum_dtype = DTYPES[accum_dtype or cfg.accum_dtype]
    whole, weights, dims = _sp_layout(cfg, policy)
    world = math.prod(policy.axis_size(a) for a in policy.axis_names)
    dp = policy.dp_size
    data_axes = spec_axes(policy.phys("batch"))
    rows_part = Partitioned("batch")
    hook = phase_hook or (lambda kind: None)
    opt_kw = ({"splits": dims, "mesh": policy.mesh}
              if isinstance(optimizer, Adafactor) else {})

    def rank_grads(params, rows):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with region(policy):
            hook("forward")
            total, met = loss_fn(leaves, rows)
            hook("backward")
            # a stub frontend's batch never reads ``embed``: zero grads,
            # as the reference's
            grads = torch.autograd.grad(total / world, list(leaves.values()),
                                        allow_unused=True)
        return (total.detach(), {k: v.detach() for k, v in met.items()},
                {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)})

    def train_step(state, batch, fault=False):
        params = state["params"]
        device = next(iter(params.values())).device
        batch = batch_to_device(batch, device)
        B = batch["labels"].shape[0]
        if B % (accum * dp):
            raise ValueError(f"global batch {B} not divisible by grad_accum "
                             f"x the data axes' size = {accum} x {dp}")
        mets, grads = [], None
        for i in range(accum):
            mb = {k: x[i * B // accum:(i + 1) * B // accum]
                  for k, x in batch.items()}
            rows = local_blocks(rows_part, mb, policy)
            total, met, g = rank_grads(params, rows)
            met["loss"] = total
            mets.append(met)
            if accum == 1:
                grads = g
            elif grads is None:
                grads = {k: v.to(accum_dtype) for k, v in g.items()}
            else:
                for k, v in g.items():
                    grads[k] += v.to(accum_dtype)
        if accum > 1:
            grads = {k: g / accum for k, g in grads.items()}
        hook("optimizer")
        with prim.use_mesh(policy.mesh):
            _sum_contributions(grads, whole)
            # the loss and nll are each data replica's: their mean over
            # the replicas is the global value (aux is global already)
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
            pair = torch.stack([metrics["loss"], metrics["nll"]])
            prim.psum_([pair], data_axes)
            metrics["loss"], metrics["nll"] = pair / dp
            if grad_compress:
                grads = {k: g.to(torch.bfloat16).float()
                         for k, g in grads.items()}
            if fault_hook is not None:
                grads = fault_hook(grads)
            sq = sum(torch.sum(torch.square(g.float())) * weights[k]
                     for k, g in grads.items())
            gnorm = torch.sqrt(prim.mesh_all_reduce_(sq))
            scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            metrics["grad_norm"] = gnorm
            flag = nonfinite_flag((metrics["loss"], grads))
            if fault:
                flag = torch.full_like(flag, HOST_FAULT)
            if nonfinite_guard or fault:
                flag = host_flag(prim.mesh_all_reduce_(flag, "max"))
            else:
                flag = 0
            new_params, new_opt = params, state["opt"]
            if not flag:
                new_params, new_opt = optimizer.update(
                    grads, state["opt"], params, scale=scale, **opt_kw)
        new_state = apply_guard(flag, state, new_params, new_opt)
        metrics["skipped"] = min(flag, 1)
        if flag >= HOST_FAULT:
            metrics["fault"] = 1
        return new_state, metrics

    return train_step


# Per-replica microbatch restriction: the boundary over the data axis is
# the BatchScatter operator, the seq dim over the ctx axis its sequence
# sibling, and ep sub-shards the batch dim alongside data; absent axes
# resolve to None, so the spec degenerates to replicated.
MB_PART = Partitioned(None, ("data", "ep"), "ctx")


def hybrid_param_parts(cfg, policy) -> dict:
    """The ``Partitioned`` declaration of the global pipeline params of
    ``cfg`` on ``policy``'s mesh: each rank's state holds its blocks under
    it (``models.convert.to_rank_params``), and a checkpoint records it."""
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.model import (pipeline_param_parts,
                                          to_pipeline_params)
    pspecs = to_pipeline_params(cfg, param_specs(cfg), policy.pipe_size)
    return pipeline_param_parts(cfg, policy, pspecs)


def _hybrid_executor(cfg, policy, *, num_microbatches, schedule, aux_weight,
                     nonfinite_flag, fault_hook, phase_hook=None):
    """(args, kwargs, sched, parts) of the executor for ``cfg`` on
    ``policy``'s mesh; ``parts`` declares the global pipeline params."""
    from repro_torch.core.pipeline import make_schedule
    from repro_torch.models.model import pipeline_fns
    from repro_torch.models.moe import EXPERT_LEAVES

    sched = make_schedule(schedule, num_microbatches, policy.pipe_size)
    pre_fn, stage_fn, logits_fn = pipeline_fns(cfg, policy, aux_weight)

    def post_fn(p_post, y, labels):
        loss, _ = cross_entropy(logits_fn(p_post, y), labels)
        return loss

    parts = hybrid_param_parts(cfg, policy)
    explicit = getattr(policy, "explicit_tp", False)
    ep_axis = policy.active_ep_axis
    stage_psum_axes = None
    if cfg.num_experts and ep_axis:
        # An expert-weight block differs per ep rank, and the combine
        # all-to-all has already brought it the cotangents of every ep
        # rank's tokens: ep leaves its drain-tail sum.  Every other leaf
        # keeps the data + ctx + ep sum.
        rep = tuple(a for a in (policy.active_data_axis,
                                policy.active_ctx_axis, ep_axis) if a)

        def stage_psum_axes(key):
            if ".moe." in key and key.rsplit(".", 1)[-1] in EXPERT_LEAVES:
                return tuple(a for a in rep if a != ep_axis)
            return rep
    kwargs = dict(pre_psum_axes=(policy.model_axis,) if explicit else (),
                  stage_psum_axes=stage_psum_axes,
                  stage_aux=bool(cfg.num_experts),
                  nonfinite_flag=nonfinite_flag, grad_fault_hook=fault_hook,
                  phase_hook=phase_hook)
    return (pre_fn, stage_fn, post_fn, policy, sched), kwargs, sched, parts


def build_hybrid_value_and_grad(cfg, policy, *, num_microbatches: int,
                                schedule: str = "1f1b",
                                aux_weight: float = 0.01,
                                nonfinite_flag: bool = False,
                                fault_hook=None):
    """The scheduled executor of ``build_hybrid_train_step``, factored:
    ``(pvg, sched)`` where ``pvg(params, {"tokens": mbs}, label_mbs) ->
    (loss, grads)`` over GLOBAL microbatched ``(M, B/M, S)`` inputs and
    global ``{pre, stage, post}`` params (``dist_jit``'s boundary), so
    tests can compare raw gradients across meshes."""
    from repro_torch.core.pipeline import pipeline_value_and_grad
    args, kwargs, sched, parts = _hybrid_executor(
        cfg, policy, num_microbatches=num_microbatches, schedule=schedule,
        aux_weight=aux_weight, nonfinite_flag=nonfinite_flag,
        fault_hook=fault_hook)
    pvg = pipeline_value_and_grad(*args, params_parts=parts,
                                  x_parts={"tokens": MB_PART},
                                  y_parts=MB_PART, **kwargs)
    return pvg, sched


def _replication(parts, policy) -> dict:
    """For each leaf, 1 / (the product of the sizes of the mesh axes but
    ``data`` that its spec leaves replicated): weighing each rank's local
    sum of squares by it and summing over one data replica counts every
    element once.  Every replica holds the same gradients after the
    drain-tail sum, so the norm does not depend on the data axis's size:
    a mesh shrunk along it, with ``virtual_dp`` taking up the loss, clips
    bit for bit as the full one."""
    out = {}
    for key, spec in resolve_parts(parts, policy).items():
        named = {a for e in spec if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))}
        k = 1
        for a in policy.axis_names:
            if a not in named and a != policy.data_axis:
                k *= policy.axis_size(a)
        out[key] = 1.0 / k
    return out


def build_hybrid_train_step(cfg, policy, optimizer, *,
                            num_microbatches: int, schedule: str = "1f1b",
                            max_grad_norm: float = 1.0,
                            aux_weight: float = 0.01,
                            nonfinite_guard: bool = True, fault_hook=None,
                            virtual_dp: int = 1, phase_hook=None):
    """Train step over the hybrid DP x pipe x TP mesh (DESIGN §5), on THIS
    RANK's state: ``state["params"]`` holds this rank's blocks of the
    pipeline params (``models.convert.to_rank_params``), and the optimizer
    moments match them.  Every rank of ``policy.mesh`` calls the step with
    the same GLOBAL batch; each cuts its own rows.

    The global batch is cut into ``num_microbatches`` microbatches, each
    restricted to this replica's rows (the ``BatchScatter`` operator over
    the data axis), and the executor of ``core/pipeline.py`` runs the
    schedule with the TP rings live inside stage bodies and the
    cross-replica gradient sum (the parameter broadcast's Eq. 9 adjoint) at
    the tail of the drain.  Then the global-norm clip, counting each
    replicated element once (:func:`_replication`, one all-reduce over
    this rank's data replica), and the optimizer update of this rank's blocks in place.
    Metrics carry the schedule's static ``bubble_fraction``.

    ``nonfinite_guard`` (default on): the executor returns the one-bit
    non-finite flag agreed over the whole mesh by ONE max all-reduce, the
    only all-reduce the guard adds; on flag 1 no rank runs the update, so
    params and moments stay bitwise unchanged, ``skipped_steps``
    increments and ``step`` advances.  ``train_step(state, batch,
    fault=True)``, on a rank that holds a fault from outside the step
    (``train/loop.py::run``), sends ``HOST_FAULT`` in that all-reduce: every
    rank then skips the update and returns ``metrics["fault"] = 1``, so all
    raise at the same step.  ``fault_hook(grads) -> grads`` is
    applied to the reduced gradients before the flag (the fault-injection
    point).  Raises ``ValueError`` when the batch does not divide by
    microbatches x dp x virtual_dp x ep or the sequence by cp.

    ``virtual_dp`` (DESIGN §10) folds lost data parallelism into gradient
    accumulation: the executor runs ``virtual_dp`` times, pass ``v`` on the
    contiguous row block ``v`` of every microbatch, and ``loss``, ``grads``
    are the passes' means and the flag their max.  ``phase_hook(kind)`` is
    the executor's instrumentation point, also called with
    ``"optimizer"`` before the clip and update.
    """
    from repro_torch.core.pipeline import pipeline_value_and_grad_local
    args, kwargs, sched, parts = _hybrid_executor(
        cfg, policy, num_microbatches=num_microbatches, schedule=schedule,
        aux_weight=aux_weight, nonfinite_flag=nonfinite_guard,
        fault_hook=fault_hook, phase_hook=phase_hook)
    run = pipeline_value_and_grad_local(*args, **kwargs)
    bubble = sched.bubble_fraction()
    dp, cp, ep = policy.dp_size, policy.ctx_size, policy.ep_size
    vdp = max(int(virtual_dp), 1)
    weights = _replication(parts, policy)
    M = num_microbatches

    def train_step(state, batch, fault=False):
        params = state["params"]
        device = next(iter(params.values())).device
        batch = batch_to_device(batch, device)
        if batch["tokens"].shape[0] % (M * dp * vdp * ep):
            raise ValueError(
                f"global batch {batch['tokens'].shape[0]} not divisible by "
                f"num_microbatches x dp x virtual_dp x ep = "
                f"{M} x {dp} x {vdp} x {ep}")
        if batch["tokens"].shape[-1] % cp:
            raise ValueError(
                f"sequence length {batch['tokens'].shape[-1]} not divisible "
                f"by cp={cp} — a clamped shard would silently drop the "
                f"trailing positions")
        mbs = {k: x.reshape((M, x.shape[0] // M) + x.shape[1:])
               for k, x in batch.items()}
        rows = mbs["tokens"].shape[1] // vdp
        outs = []
        for v in range(vdp):
            block = {k: x[:, v * rows:(v + 1) * rows] for k, x in mbs.items()}
            mine = local_blocks(MB_PART, block, policy)
            with region(policy):
                outs.append(run(params, {"tokens": mine["tokens"]},
                                mine["labels"], fault=fault))
        if vdp == 1:
            loss, grads = outs[0][0], outs[0][1]
        else:
            loss = sum(o[0] for o in outs) / vdp
            grads = {k: sum(o[1][k] for o in outs) / vdp for k in params}
        if phase_hook is not None:
            phase_hook("optimizer")
        with prim.use_mesh(policy.mesh):
            sq = sum(torch.sum(torch.square(g.float())) * weights[k]
                     for k, g in grads.items())
            gnorm = torch.sqrt(prim.mesh_all_reduce_(sq, replica=True))
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "bubble_fraction": bubble}
        if nonfinite_guard:
            # agreed over the mesh by the executor: the same on every rank
            flag = host_flag(combine_flags(*(o[2] for o in outs)))
            new_params, new_opt = params, state["opt"]
            if not flag:
                new_params, new_opt = optimizer.update(
                    grads, state["opt"], params, scale=scale)
            new_state = apply_guard(flag, state, new_params, new_opt)
            metrics["skipped"] = min(flag, 1)
            if flag >= HOST_FAULT:
                metrics["fault"] = 1
        else:
            new_params, new_opt = optimizer.update(grads, state["opt"],
                                                   params, scale=scale)
            new_state = {"params": new_params, "opt": new_opt,
                         "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def build_pipeline_train_step(cfg, policy, optimizer, *,
                              num_microbatches: int, schedule: str = "1f1b",
                              max_grad_norm: float = 1.0,
                              nonfinite_guard: bool = True, fault_hook=None):
    """Train step over a pipeline-parallel (pipe, model) mesh: the dp = 1
    face of ``build_hybrid_train_step`` (the data axis is absent, so the
    per-replica restriction and the cross-replica sums are no-ops)."""
    return build_hybrid_train_step(
        cfg, policy, optimizer, num_microbatches=num_microbatches,
        schedule=schedule, max_grad_norm=max_grad_norm,
        nonfinite_guard=nonfinite_guard, fault_hook=fault_hook)


def init_train_state(cfg, params, optimizer):
    return {"params": params, "opt": optimizer.init(params), "step": 0,
            "skipped_steps": 0}
