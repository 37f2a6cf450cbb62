"""Pipeline parallelism from adjoint SendRecv operators (mirrors
``repro/core/pipeline.py``; paper §3, DESIGN §4).

Stage-to-stage activation movement along a ``pipe`` mesh axis is the
:class:`StageBoundary` operator, a non-periodic shift built on the port's
``SendRecv``.  Its adjoint is the reversed-offset receive
(``StageBoundary(axis, k).T == StageBoundary(axis, -k)``).

On top of it sits a microbatch scheduler.  A :class:`Schedule` is a static
(ticks x stages) table of F/B/idle slots plus the matching receive tables,
from two generators (numpy, a copy of the reference's):

- :func:`schedule_fill_drain`: GPipe, all forwards then all backwards;
  activation buffer depth M.
- :func:`schedule_1f1b`: stage s runs S-1-s warmup forwards, then
  alternates F/B, then drains; the same bubble (S-1)/(M+S-1) under equal
  F/B cost, activation buffer depth min(S, M).

:func:`pipeline_value_and_grad_local` is the executor on this rank's
blocks.  The reference runs one ``jax.vjp`` of the stage on EVERY tick and
masks the unused half by the tables, because a ``shard_map`` program must
be uniform.  The port's ranks are processes, so each rank branches on its
own ``ops[t, s]``: an F tick runs the stage forward without a graph (the
last stage skips it: its output feeds nothing, since its B tick recomputes
from the saved input); a B tick recomputes the stage at the saved input
and calls ``torch.autograd.grad`` with the received cotangent (or, on the
last stage, through the epilogue's loss); an idle tick computes nothing.
Ranks that share a ``model``, ``data``, ``ctx`` or ``ep`` group share the
stage index, so they branch alike and their collectives inside a stage
body stay matched.  Only the boundary crosses stages, and whether it runs
on a tick is read from the GLOBAL tables: every rank joins a tick's
boundary shift, or every rank skips a tick on which nothing crosses.

Gradients accumulate in fp32 in microbatch order.  The drain tail sums
them over the pipe axis and the replica axes (data, ctx, ep), the data
axis in its own all-reduce after the others (``psum_split``), scales by
1/(M dp cp ep), applies ``grad_fault_hook``, and, with ``nonfinite_flag``,
agrees the guard's one bit by ONE max all-reduce over the whole mesh.

:func:`pipeline_value_and_grad` wraps the executor in ``dist_jit``'s
boundary: a function of GLOBAL ``(params, xs, ys)``, as the reference's.

Schedules and the adjoint pairing are static and device-free::

    >>> StageBoundary("pipe").T == StageBoundary("pipe", -1)
    True
    >>> s = schedule_1f1b(8, 4)
    >>> s.num_ticks, s.fwd_depth, schedule_fill_drain(8, 4).fwd_depth
    (22, 4, 8)
    >>> round(s.bubble_fraction(), 3)       # (S-1)/(M+S-1)
    0.273
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..resilience.guard import HOST_FAULT, nonfinite_flag as _nonfinite_flag
from ..tree import subtree, tree_map
from . import primitives as prim
from .compile import dist_jit
from .linop import PartitionSpec as P
from .linop import SendRecv

__all__ = [
    "StageBoundary",
    "Schedule",
    "schedule_fill_drain",
    "schedule_1f1b",
    "make_schedule",
    "pipeline_value_and_grad",
    "pipeline_value_and_grad_local",
]

_IDLE, _FWD, _BWD = 0, 1, 2
_KIND = {_IDLE: "idle", _FWD: "F", _BWD: "B"}


@dataclass(frozen=True)
class StageBoundary(SendRecv):
    """Stage boundary on the ``pipe`` mesh axis (paper §3 send/receive).

    Forward: copy this stage's activation to the stage ``offset`` positions
    downstream (non-periodic: the first/last stage receives zeros, the
    paper's fresh-allocation convention).  Adjoint identity:
    ``StageBoundary(axis, k).T == StageBoundary(axis, -k)``, the
    reversed-offset receive, which is how the executor returns cotangents
    upstream.
    """

    def _adjoint(self) -> "StageBoundary":
        """Reversed-offset boundary (the backward send)."""
        return StageBoundary(self.axis, -self.offset)


# ---------------------------------------------------------------------------
# Schedules.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Schedule:
    """A static microbatch schedule: per-(tick, stage) op and index tables.

    ``ops[t, s]``    0 idle / 1 forward / 2 backward for stage s at tick t.
    ``mbs[t, s]``    the microbatch index the op acts on (0 when idle).
    ``recv_f[t, s]`` microbatch whose forward activation arrives at stage s
                     at the END of tick t (-1: none), i.e. stage s-1 ran F.
    ``recv_b[t, s]`` microbatch whose cotangent arrives from stage s+1 at
                     the END of tick t (-1: none).
    ``fwd_depth`` / ``bwd_depth``: minimal activation / cotangent ring-buffer
    depths such that modular slot assignment (m % depth) is collision-free
    for the liveness intervals this schedule induces.
    """

    name: str
    num_stages: int
    num_microbatches: int
    ops: np.ndarray
    mbs: np.ndarray
    recv_f: np.ndarray
    recv_b: np.ndarray
    fwd_depth: int
    bwd_depth: int

    @property
    def num_ticks(self) -> int:
        """Total wall-clock ticks (each tick = one F or B slot per stage)."""
        return int(self.ops.shape[0])

    def bubble_fraction(self) -> float:
        """Idle stage-ticks / total stage-ticks: the pipeline bubble."""
        return float((self.ops == _IDLE).mean())

    def counts(self) -> tuple[int, int, int]:
        """(#forward, #backward, #idle) slots over the whole table."""
        return (int((self.ops == _FWD).sum()), int((self.ops == _BWD).sum()),
                int((self.ops == _IDLE).sum()))


def _greedy_schedule(name: str, num_microbatches: int, num_stages: int,
                     in_flight_cap) -> Schedule:
    """Tick-synchronous greedy scheduler.

    At every tick each stage, using only information from STRICTLY EARLIER
    ticks (data crosses a boundary between ticks), runs a forward if its
    next microbatch's input has arrived and its in-flight count is below
    ``in_flight_cap(stage)``, else a backward if a cotangent has arrived,
    else idles.  ``cap = M`` gives GPipe fill-drain; ``cap = S - s`` the
    classic non-interleaved 1F1B pattern.
    """
    M, S = num_microbatches, num_stages
    if M < 1 or S < 1:
        raise ValueError(f"need M >= 1 microbatches and S >= 1 stages, got "
                         f"M={M}, S={S}")
    f_done = [[None] * M for _ in range(S)]   # tick when F_s(m) completed
    b_done = [[None] * M for _ in range(S)]   # tick when B_s(m) completed
    next_f = [0] * S
    next_b = [0] * S
    rows_op, rows_mb = [], []
    t = 0
    while any(nb < M for nb in next_b):
        if t > 4 * (M + S) * max(M, S):
            raise RuntimeError(f"schedule {name!r} failed to converge")
        op_row, mb_row = [_IDLE] * S, [0] * S
        for s in range(S):
            mf, mb_ = next_f[s], next_b[s]
            f_ready = mf < M and (
                s == 0 or (f_done[s - 1][mf] is not None
                           and f_done[s - 1][mf] < t))
            if s == S - 1:
                b_ready = mb_ < M and (f_done[s][mb_] is not None
                                       and f_done[s][mb_] < t)
            else:
                b_ready = mb_ < M and (b_done[s + 1][mb_] is not None
                                       and b_done[s + 1][mb_] < t)
            if f_ready and (mf - mb_) < in_flight_cap(s):
                op_row[s], mb_row[s] = _FWD, mf
                f_done[s][mf] = t
                next_f[s] += 1
            elif b_ready:
                op_row[s], mb_row[s] = _BWD, mb_
                b_done[s][mb_] = t
                next_b[s] += 1
        rows_op.append(op_row)
        rows_mb.append(mb_row)
        t += 1
    ops = np.asarray(rows_op, np.int32)
    mbs = np.asarray(rows_mb, np.int32)
    T = ops.shape[0]

    # Receive tables: what lands in each stage's buffers at tick end.
    recv_f = np.full((T, S), -1, np.int32)
    recv_b = np.full((T, S), -1, np.int32)
    for tt in range(T):
        for s in range(S):
            if s > 0 and ops[tt, s - 1] == _FWD:
                recv_f[tt, s] = mbs[tt, s - 1]
            if s < S - 1 and ops[tt, s + 1] == _BWD:
                recv_b[tt, s] = mbs[tt, s + 1]

    # Minimal collision-free ring-buffer depths under modular slots.
    def min_depth(intervals_per_stage):
        for d in range(1, M + 1):
            ok = True
            for iv in intervals_per_stage:
                for m, (w, r) in iv.items():
                    for m2 in range(m + d, M, d):
                        if m2 in iv and iv[m2][0] <= r:
                            ok = False
            if ok:
                return d
        return M

    f_iv, b_iv = [], []
    for s in range(S):
        # activation for m: written when it arrives (or, stage 0, at its own
        # F tick); last read at this stage's B tick (the recompute input).
        f_iv.append({m: ((f_done[s][m] if s == 0 else f_done[s - 1][m]),
                         b_done[s][m]) for m in range(M)})
        # cotangent for m: written at stage s+1's B tick; read at ours.
        if s < S - 1:
            b_iv.append({m: (b_done[s + 1][m], b_done[s][m])
                         for m in range(M)})
    return Schedule(name, S, M, ops, mbs, recv_f, recv_b,
                    min_depth(f_iv), max(min_depth(b_iv), 1))


def schedule_fill_drain(num_microbatches: int, num_stages: int) -> Schedule:
    """GPipe: fill the pipe with all M forwards, then drain all backwards.

    Bubble fraction (S-1)/(M+S-1) per phase; activation buffer depth M.
    """
    return _greedy_schedule("fill_drain", num_microbatches, num_stages,
                            lambda s: num_microbatches)


def schedule_1f1b(num_microbatches: int, num_stages: int) -> Schedule:
    """Non-interleaved 1F1B: stage s holds at most S-s microbatches in
    flight (S-1-s warmup forwards, then alternate F/B, then drain).

    Same bubble as fill-drain under equal F/B cost; activation buffer depth
    min(S, M) instead of M, the Megatron-LM memory argument.
    """
    S = num_stages
    return _greedy_schedule("1f1b", num_microbatches, num_stages,
                            lambda s: S - s)


def make_schedule(name: str, num_microbatches: int, num_stages: int) -> Schedule:
    """Look up a schedule generator by name ('fill_drain' | '1f1b')."""
    gens = {"fill_drain": schedule_fill_drain, "1f1b": schedule_1f1b}
    if name not in gens:
        raise ValueError(f"unknown schedule {name!r}; have {sorted(gens)}")
    return gens[name](num_microbatches, num_stages)


# ---------------------------------------------------------------------------
# The per-rank executor.
# ---------------------------------------------------------------------------

def _grad_leaves(tree: dict) -> dict:
    return {k: v.detach().requires_grad_() for k, v in tree.items()}


def pipeline_value_and_grad_local(pre_fn, stage_fn, post_fn, policy,
                                  schedule, *, pre_psum_axes=(),
                                  post_psum_axes=(), stage_psum_axes=None,
                                  stage_aux=False, nonfinite_flag=False,
                                  grad_fault_hook=None, phase_hook=None):
    """Build ``f(params, xs, ys) -> (loss, grads)`` on THIS RANK's blocks.

    ``f`` runs inside ``compile.region(policy)`` (``dist_jit`` enters it;
    the hybrid train step enters it directly).  ``params`` is a flat dict
    with keys ``pre.*``, ``stage.*`` and ``post.*``: the pre/post leaves
    whole (they are replicated), each stage leaf this rank's block,
    ``(1, n_super/S, ...)`` with its TP shard.  ``xs`` (a dict of tensors)
    and ``ys`` lead with the microbatch dim, (M, rows, ...), already
    restricted to this rank's rows.  ``grads`` matches ``params`` key for
    key and block for block, in fp32; ``loss`` is the global mean loss on
    every rank.  Every rank of ``policy.mesh`` calls ``f`` together.

    The arguments are the reference's (``repro/core/pipeline.py``):
    ``pre_fn(p_pre, microbatch_x) -> act`` (stage 0), ``stage_fn(p_stage,
    act) -> act`` (or ``(act, aux)`` with ``stage_aux``; it gets the stage
    leaves without their stage dim), ``post_fn(p_post, act, microbatch_y)
    -> scalar loss`` (last stage); ``pre_psum_axes`` / ``post_psum_axes``:
    mesh axes over which pre/post cotangents are contributions to sum;
    ``stage_psum_axes(key) -> axes``: per stage leaf (``key`` without the
    ``stage.`` prefix), the axes its gradient sums over (default data +
    ctx + ep); ``nonfinite_flag``: also return the globally agreed int32
    one-bit non-finite flag, ``f -> (loss, grads, flag)``, and take
    ``f(..., fault=True)`` on a rank that holds a fault from outside the
    step (the flag is then at least ``HOST_FAULT`` on every rank);
    ``grad_fault_hook(grads) -> grads``: applied after the drain-tail sums,
    before the flag.  ``phase_hook(kind)``, an instrumentation point, is
    called as each tick starts with ``"F"``, ``"B"`` or ``"idle"`` (this
    rank's op), with ``"boundary"`` before a tick's stage shift (the hop
    and the wait for the other stages), and with ``"drain"`` before the
    drain tail.
    """
    pipe_axis = policy.pipe_axis
    if pipe_axis is None:
        raise ValueError("pipeline_value_and_grad needs policy.pipe_axis")
    S, M = schedule.num_stages, schedule.num_microbatches
    if policy.axis_size(pipe_axis) != S:
        raise ValueError(
            f"schedule has {S} stages but mesh axis {pipe_axis!r} has size "
            f"{policy.axis_size(pipe_axis)}")
    # Hybrid DP x pipe x ctx x TP x EP (DESIGN §5-6, §8): every replica runs
    # the same schedule on its own rows (and ctx rank on its own sequence
    # shard); the replica axes join every drain-tail reduction.
    data_axis = policy.active_data_axis
    dp_axes = (data_axis,) if data_axis else ()
    ctx_axis = policy.active_ctx_axis
    ep_axis = policy.active_ep_axis
    rep_axes = dp_axes + tuple(a for a in (ctx_axis, ep_axis) if a)
    inv_m = 1.0 / (M * policy.dp_size * policy.ctx_size * policy.ep_size)
    boundary = StageBoundary(pipe_axis)          # forward send
    boundary_T = boundary.T                      # adjoint: backward send
    ops, mbs = schedule.ops, schedule.mbs
    recv_f, recv_b = schedule.recv_f, schedule.recv_b
    fdep, bdep = schedule.fwd_depth, schedule.bwd_depth
    # Whether anything crosses each way on a tick, from the GLOBAL tables:
    # every rank joins that tick's shift, or every rank skips it.
    sends_f = (ops[:, :-1] == _FWD).any(axis=1)
    sends_b = (ops[:, 1:] == _BWD).any(axis=1)
    hook = phase_hook or (lambda kind: None)

    def psum_split(tensors, axes):
        """The reference's ``psum_split``: the intra-replica axes first,
        then the data axis in its own all-reduce."""
        prim.psum_(tensors, [a for a in axes if a not in dp_axes])
        prim.psum_(tensors, dp_axes)

    def run(params, xs, ys, fault=False):
        if fault and not nonfinite_flag:
            raise ValueError("a held fault is carried by the non-finite "
                             "flag's all-reduce: build with nonfinite_flag")
        s = prim.axis_index(pipe_axis)
        p_pre, p_post = subtree(params, "pre"), subtree(params, "post")
        # stage leaves arrive as this rank's (1, ...) block: drop the dim
        p_stage = {k: v[0] for k, v in subtree(params, "stage").items()}
        with torch.no_grad():
            act = pre_fn(p_pre, tree_map(lambda a: a[0], xs))
        fbuf, bbuf = {}, {}
        acc = {"pre": {}, "stage": {}, "post": {}}
        loss = torch.zeros((), dtype=torch.float32, device=act.device)

        def accumulate(part, names, grads):
            for k, g in zip(names, grads):
                if k in acc[part]:
                    acc[part][k].add_(g)
                else:
                    acc[part][k] = g.float()   # 0 + g, in fp32

        def check(y):
            if (y.shape, y.dtype) != (act.shape, act.dtype):
                raise ValueError(
                    f"stage body must preserve the activation: in "
                    f"{tuple(act.shape)}/{act.dtype}, out "
                    f"{tuple(y.shape)}/{y.dtype}")
            return y

        def forward(m):
            with torch.no_grad():
                x_in = (pre_fn(p_pre, tree_map(lambda a: a[m], xs)) if s == 0
                        else fbuf[m % fdep])
                out = stage_fn(p_stage, x_in)
            return check(out[0] if stage_aux else out)

        def backward(m):
            """The rematerialized backward: the stage (and the prologue at
            s = 0, the epilogue at s = S-1) re-run at the saved input under
            autograd; accumulates the grads and the loss.  Returns the
            cotangent of the stage input to send upstream (None at s = 0)."""
            nonlocal loss
            with torch.enable_grad():
                leaves = {"stage": _grad_leaves(p_stage)}
                if s == 0:
                    leaves["pre"] = _grad_leaves(p_pre)
                    x_in = pre_fn(leaves["pre"], tree_map(lambda a: a[m], xs))
                else:
                    x_in = fbuf.pop(m % fdep).detach().requires_grad_()
                out = stage_fn(leaves["stage"], x_in)
                y, aux = out if stage_aux else (out, None)
                check(y)
                if s == S - 1:
                    leaves["post"] = _grad_leaves(p_post)
                    loss_m = post_fn(leaves["post"], y, ys[m])
                    roots, cots = [loss_m], [torch.ones_like(loss_m)]
                else:
                    loss_m = None
                    roots, cots = [y], [bbuf.pop(m % bdep)]
                if stage_aux:
                    # this stage's aux cotangent seeded at 1 through the
                    # same rematerialized backward
                    roots.append(aux)
                    cots.append(torch.ones_like(aux))
                inputs = [(part, k, v) for part, tree in leaves.items()
                          for k, v in tree.items()]
                wrt = [v for _, _, v in inputs] + ([x_in] if s > 0 else [])
                grads = torch.autograd.grad(roots, wrt, cots,
                                            allow_unused=True,
                                            materialize_grads=True)
            for part in leaves:
                accumulate(part, [k for p, k, _ in inputs if p == part],
                           [g for (p, _, _), g in zip(inputs, grads)
                            if p == part])
            if loss_m is not None:
                loss = loss + loss_m.detach().float()
            if stage_aux:
                loss = loss + aux.detach().float()
            return grads[-1].detach() if s > 0 else None

        for t in range(ops.shape[0]):
            op, m = int(ops[t, s]), int(mbs[t, s])
            hook(_KIND[op])
            y = gx = None
            if op == _FWD and s < S - 1:
                y = forward(m)
            elif op == _BWD:
                gx = backward(m)
            if sends_f[t] or sends_b[t]:
                hook("boundary")
            with torch.no_grad():
                # boundary crossings: activations ride the forward operator,
                # cotangents its adjoint; a rank with nothing to send sends
                # zeros (the reference's masked send)
                if sends_f[t]:
                    got = boundary(y if y is not None else torch.zeros_like(act))
                    if recv_f[t, s] >= 0:
                        fbuf[int(recv_f[t, s]) % fdep] = got
                if sends_b[t]:
                    got = boundary_T(gx if gx is not None
                                     else torch.zeros_like(act))
                    if recv_b[t, s] >= 0:
                        bbuf[int(recv_b[t, s]) % bdep] = got

        hook("drain")
        with torch.no_grad():
            # Only the owning stage accumulated pre/post/loss; every rank
            # joins the sums with zeros where it holds nothing.
            def full(part, tree):
                return [acc[part][k] if k in acc[part] else
                        torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device)
                        for k, v in tree.items()]
            g_pre, g_post = full("pre", p_pre), full("post", p_post)
            g_stage = full("stage", p_stage)
            psum_split(g_pre, (pipe_axis,) + rep_axes + tuple(pre_psum_axes))
            psum_split(g_post, (pipe_axis,) + rep_axes
                       + tuple(post_psum_axes))
            if stage_psum_axes is None:
                psum_split(g_stage, rep_axes)
            else:
                for k, g in zip(p_stage, g_stage):
                    axes = tuple(stage_psum_axes(k))
                    if axes:   # no axes: the leaf's grad is complete here
                        psum_split([g], axes)
            psum_split([loss], (pipe_axis,) + rep_axes)
            loss.mul_(inv_m)
            grads = {}
            for part, tree, gs in (("pre", p_pre, g_pre),
                                   ("stage", p_stage, g_stage),
                                   ("post", p_post, g_post)):
                for k, g in zip(tree, gs):
                    g.mul_(inv_m)
                    grads[f"{part}.{k}"] = g[None] if part == "stage" else g
            grads = {k: grads[k] for k in params}
        if grad_fault_hook is not None:
            grads = grad_fault_hook(grads)
        if not nonfinite_flag:
            return loss, grads
        # DESIGN §9: the skip decision as a one-bit all-reduce.  Each rank
        # reduces its loss and gradient blocks to one local bit; one max
        # all-reduce over the whole mesh agrees it, so every rank returns
        # the same flag and takes the same branch.
        # A rank that holds a fault from outside the step (``fault``)
        # sends HOST_FAULT instead, so every rank reads the fault here.
        flag = _nonfinite_flag((loss, grads))
        if fault:
            flag = torch.full_like(flag, HOST_FAULT)
        flag = prim.mesh_all_reduce_(flag, "max")
        return loss, grads, flag

    return run


def pipeline_value_and_grad(pre_fn, stage_fn, post_fn, policy, schedule, *,
                            params_parts, x_parts, y_parts, **kw):
    """Build ``f(params, xs, ys) -> (loss, grads)`` of GLOBAL arguments for
    a scheduled pipeline, as the reference's: :func:`pipeline_value_and_grad_local`
    inside ``dist_jit``'s boundary.

    ``params_parts``: flat dict of ``Partitioned`` declarations matching
    the ``{pre.*, stage.*, post.*}`` params; stage leaves are stacked
    ``(num_stages, ...)`` and MUST lead with the pipe axis; pre/post
    leaves resolve pipe-replicated.  ``x_parts`` / ``y_parts``: boundary
    declarations for the microbatched inputs (leading dim = microbatches).
    ``kw``: the executor's keywords.  Returns the global loss and the
    global grads (``+ flag`` with ``nonfinite_flag``) on every rank; every
    rank of the mesh calls ``f`` together.
    """
    core = pipeline_value_and_grad_local(pre_fn, stage_fn, post_fn, policy,
                                         schedule, **kw)
    out_parts = ((P(), params_parts, P()) if kw.get("nonfinite_flag")
                 else (P(), params_parts))
    return dist_jit(core, policy, (params_parts, x_parts, y_parts), out_parts)
