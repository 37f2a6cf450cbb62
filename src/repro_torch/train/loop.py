"""Training loop with fault tolerance and straggler monitoring (mirrors
``repro/train/loop.py``).

Restart contract: all state needed to resume (parameters, optimizer
moments, step counter, skipped-step count) is in the checkpoint, and the
data pipeline is addressed by step.  ``run`` therefore resumes exactly
after any crash by restoring the newest *verified* checkpoint, and
``restart_on_failure`` wraps the step loop in a supervised retry (the
in-process analogue of a cluster controller rescheduling a failed job): a
declared set of recoverable exception types, seeded jittered exponential
backoff, fallback past corrupt checkpoints (quarantined as ``.corrupt``),
and NaN-streak rollback: when the guard skips ``rollback_after_skips``
steps in a row the poison is persistent, so the supervisor restores the
last good checkpoint and advances the data iterator past the poisoned
window (``data_offset``: batch ``step + offset`` feeds step ``step``).
``elastic_restart_on_failure`` survives the permanent loss of a mesh
slice: it shrinks the mesh over the surviving ranks, reshards the newest
verified checkpoint onto it and folds the lost data parallelism into
gradient accumulation (DESIGN §10).

On a mesh the loop runs on every rank (``policy``, ``parts``: the step's
mesh and its parameters' partition declaration, where the reference takes
``shardings``), and no rank restarts alone: a restart pairs every rank's
next collective with its peers', so the supervisors restart the mesh only
on a fault every rank raises at the same step.  The plan's faults and a
non-finite streak are such by construction (every rank runs the same plan;
the guard's flag is agreed).  A recoverable fault that one rank raises
outside the step (the ``fail_at_step`` hook, the logger, a checkpoint
write) is held by ``run`` and carried to every rank by the next step's
guard all-reduce (or the loop's closing agreement), so every rank raises
:class:`MeshFault` at the same step; the groups stay intact and the
restart waits on no timeout, on NCCL as on gloo.  Every rank then restores
the same checkpoint (the verdicts are agreed over the mesh,
``checkpoint/ckpt.py``).  A fault raised inside a step on one rank alone
cannot be carried (its peers wait in a collective it never joins): it
ends the run, as any fault outside the recoverable set does.

Straggler mitigation: an EWMA step-time monitor flags steps slower than
``factor`` x the moving average.  ``run`` and the supervisors return a
:class:`History` of per-step records whose ``.health`` dict carries the
counters an operator would page on.
"""

from __future__ import annotations

import contextlib
import math
import random as _random
import time
from dataclasses import dataclass

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.tree import tree_leaves, tree_map


class History(list):
    """Per-step records plus structured health counters in ``.health``."""

    def __init__(self, *a):
        super().__init__(*a)
        self.health = {"restarts": 0, "rollbacks": 0, "skipped_steps": 0,
                       "slow_steps": 0, "backoff_seconds": 0.0,
                       "quarantined_checkpoints": 0, "mesh_shrinks": 0}


class NonFiniteStreakError(RuntimeError):
    """The guard skipped ``streak`` consecutive steps: the poison is
    persistent (bad data window, diverged state), not a transient burst.
    Carries the window so the supervisor can advance the data stream past
    it."""

    def __init__(self, first_step: int, last_step: int, streak: int):
        super().__init__(
            f"non-finite gradients for {streak} consecutive steps "
            f"({first_step}..{last_step})")
        self.first_step, self.last_step, self.streak = first_step, last_step, streak


class MeshFault(RuntimeError):
    """A recoverable fault that one rank raised outside the step, agreed
    over the mesh: ``run`` raises it on every rank at the same step
    (``held``: the fault this rank saw, empty on its peers)."""

    def __init__(self, step: int, held):
        what = (f"{type(held[0]).__name__}: {held[0]}" if held
                else "a peer's recoverable fault")
        super().__init__(f"{what} (agreed over the mesh at step {step})")


@contextlib.contextmanager
def _holding(held: list, types):
    """Run the body; a fault of ``types`` it raises is appended to
    ``held`` instead of propagating (``types=()`` holds nothing)."""
    try:
        yield
    except types as e:
        held.append(e)


@dataclass
class StragglerMonitor:
    alpha: float = 0.1
    factor: float = 1.5
    ewma: float | None = None
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.slow_steps += 1
        return slow


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    async_ckpt: bool = True
    fail_at_step: int | None = None      # injected fault: raise at this step
    rollback_after_skips: int | None = None  # NaN-streak rollback threshold


def _sync(t):
    """Wait for the device ``t`` lives on (the step's last kernels)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def run(state, train_step, data_iter, loop_cfg: LoopConfig, *, logger=print,
        history: History | None = None, data_offset: int = 0, policy=None,
        parts=None, recoverable=()):
    """Run the step loop from ``state``; returns (state, history).

    ``data_offset`` shifts the stateless data addressing: step ``i``
    consumes batch ``i + data_offset``.  ``history`` lets the supervisor
    thread one :class:`History` through restarts.  A step's time is the
    host clock from before the step to the end of its last kernel.  Every
    ``ckpt_every`` steps the state is saved (async unless
    ``async_ckpt=False``; on ``policy``'s mesh under ``parts``), and
    pending saves are joined before returning.

    On a mesh, a fault of ``recoverable`` that this rank raises outside
    the step (the ``fail_at_step`` hook, the logger, a save or a failed
    async write) is held: the next step carries it to every rank through
    the guard's all-reduce (``train_step(state, batch, fault=True)``; see
    ``build_hybrid_train_step``) and the loop's end through one agreement
    (``checkpoint.settle``), and every rank raises :class:`MeshFault`
    there.  Off a mesh it is raised at once.
    """
    monitor = StragglerMonitor()
    if history is None:
        history = History()
    held: list = []
    hold = recoverable if policy is not None else ()
    start = int(state["step"])
    streak_first = None
    streak = 0
    for step in range(start, loop_cfg.total_steps):
        data_step, batch = next(data_iter)
        if data_step != step + data_offset:
            raise RuntimeError(f"data iterator at batch {data_step}, loop at "
                               f"step {step} with offset {data_offset}")
        t0 = time.perf_counter()
        with _holding(held, hold):
            if (loop_cfg.fail_at_step is not None
                    and step == loop_cfg.fail_at_step):
                raise RuntimeError(f"injected fault at step {step}")
        state, metrics = (train_step(state, batch, fault=True) if held
                          else train_step(state, batch))
        _sync(metrics["loss"])
        if metrics.pop("fault", 0):
            raise MeshFault(step, held) from (held[0] if held else None)
        dt = time.perf_counter() - t0
        slow = monitor.observe(dt)
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(step=step, sec=dt, slow=slow)
        history.append(rec)
        history.health["slow_steps"] += slow
        skipped = bool(rec.get("skipped", 0.0))
        if skipped:
            history.health["skipped_steps"] += 1
            streak_first = step if streak == 0 else streak_first
            streak += 1
            with _holding(held, hold):
                logger(f"step {step:5d}  non-finite gradients: step SKIPPED "
                       f"(streak {streak})")
            if (loop_cfg.rollback_after_skips
                    and streak >= loop_cfg.rollback_after_skips):
                raise NonFiniteStreakError(streak_first, step, streak)
        else:
            streak = 0
        if step % loop_cfg.log_every == 0 or slow:
            with _holding(held, hold):
                logger(f"step {step:5d}  loss {rec['loss']:.4f}  "
                       f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.0f} ms"
                       + ("  [STRAGGLER]" if slow else ""))
        if (loop_cfg.ckpt_dir and loop_cfg.ckpt_every
                and (step + 1) % loop_cfg.ckpt_every == 0):
            saver = (ckpt_lib.save_async if loop_cfg.async_ckpt
                     else ckpt_lib.save)
            with _holding(held, hold):
                saver(loop_cfg.ckpt_dir, step + 1, state, keep=loop_cfg.keep,
                      policy=policy, parts=parts)
        if policy is not None:
            with _holding(held, hold):
                ckpt_lib.check_pending()
    with _holding(held, hold):
        ckpt_lib.wait_pending()
    if policy is not None and ckpt_lib.settle(policy, fault=bool(held)):
        raise MeshFault(loop_cfg.total_steps, held) from (
            held[0] if held else None)
    return state, history


# The declared recoverable surface: planned crashes and loop faults
# (RuntimeError covers InjectedCrash and the fail_at_step hook), I/O flakes
# around checkpoint storage (OSError), and host-side float traps.
# Programming errors (TypeError, ValueError, KeyError...) stay fatal:
# restarting can't fix those and the retry would loop.
RECOVERABLE = (RuntimeError, OSError, FloatingPointError)


def _skeleton(state):
    """``(like, device)``: ``state``'s tree as ``meta`` tensors (shapes and
    dtypes, no memory) and the one device its tensors live on."""
    devices = {t.device for t in tree_leaves(state)
               if isinstance(t, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"a train state on one device expected: {devices}")
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, state)
    return like, (devices.pop() if devices else None)


def _resume(loop_cfg, make_state, skel, history, logger, *, policy=None,
            **kw):
    """``(state, start, skel)``: the newest verified checkpoint of
    ``loop_cfg.ckpt_dir`` restored, or ``make_state()`` at step 0 without
    one.  The restore lands on ``skel`` (:func:`_skeleton` of the first
    state made, or of a ``make_state()`` freed before the restore), kept
    for later restarts, so a restart neither holds two train states nor
    builds one to throw away; quarantined checkpoints are counted in
    ``history``."""
    if loop_cfg.ckpt_dir and _restart_point(loop_cfg, policy):
        if skel is None:
            skel = _skeleton(make_state())
        like, device = skel
        got = ckpt_lib.restore_latest_verified(
            loop_cfg.ckpt_dir, like=like, device=device, logger=logger,
            policy=policy, **kw)
        if got is not None:
            state, start, quarantined = got
            history.health["quarantined_checkpoints"] += len(quarantined)
            logger(f"resumed from checkpoint step {start}"
                   + (f" (quarantined corrupt: {quarantined})" if quarantined
                      else ""))
            return state, start, skel
    state = make_state()
    if loop_cfg.ckpt_dir and skel is None:
        skel = _skeleton(state)
    return state, 0, skel


def _backoff(restarts, rng, history, sleep, base, cap, jitter):
    delay = min(cap, base * (2 ** (restarts - 1)))
    delay *= 1.0 + jitter * rng.random()
    history.health["backoff_seconds"] += delay
    sleep(delay)


def restart_on_failure(make_state, train_step, make_data_iter,
                       loop_cfg: LoopConfig, *, policy=None, parts=None,
                       max_restarts: int = 3, recoverable=RECOVERABLE,
                       backoff_base: float = 0.5, backoff_max: float = 30.0,
                       backoff_jitter: float = 0.1, seed: int = 0,
                       logger=print, sleep=time.sleep):
    """Supervised retry loop: the single-process analogue of a cluster
    restart, and on a mesh (``policy``, ``parts``) its per-rank form.

    On a mesh it restarts only on faults every rank raised at the same
    step (:func:`_agreed`; ``run`` carries a recoverable fault one rank
    raised outside the step to every rank), so no rank restarts alone.
    On a recoverable failure: restore the newest checkpoint that passes
    verification (corrupt ones are quarantined as ``.corrupt`` and the
    previous intact one is used, DESIGN §9), back off with seeded jittered
    exponential delay (``backoff_base * 2^k``, capped at ``backoff_max``),
    and resume.  On a :class:`NonFiniteStreakError` (persistent poison):
    additionally advance the stateless data iterator past the poisoned
    window via ``data_offset``.  Raises after ``max_restarts`` recoveries;
    exception types outside ``recoverable`` propagate at once.  Each data
    iterator is closed when its attempt ends.  Returns ``(state,
    history)``, ``history.health`` carrying the restart, rollback, skip,
    backoff and quarantine counters of all attempts.
    """
    rng = _random.Random(seed)
    history = History()
    restarts = 0
    data_offset = 0
    skel = None
    while True:
        state, start, skel = _resume(loop_cfg, make_state, skel, history,
                                     logger, policy=policy, parts=parts)
        data_iter = make_data_iter(start + data_offset)
        try:
            return run(state, train_step, data_iter, loop_cfg, logger=logger,
                       history=history, data_offset=data_offset,
                       policy=policy, parts=parts, recoverable=recoverable)
        except NonFiniteStreakError as e:
            restarts += 1
            history.health["rollbacks"] += 1
            # the poisoned data window is [first skipped batch, last skipped
            # batch]; replay model state from the last good checkpoint but
            # feed it the batches AFTER the window (a pure index shift)
            data_offset = max(data_offset, e.last_step + 1 + data_offset
                              - _restart_point(loop_cfg, policy))
            logger(f"persistent non-finite streak: {e}; rolling back with "
                   f"data_offset={data_offset} "
                   f"(restart {restarts}/{max_restarts})")
            if restarts >= max_restarts:
                raise
        except recoverable as e:
            if not _agreed(e, policy):
                raise
            restarts += 1
            history.health["restarts"] += 1
            logger(f"failure: {e}; restart {restarts}/{max_restarts}")
            if restarts >= max_restarts:
                raise
            if loop_cfg.fail_at_step is not None:
                loop_cfg.fail_at_step = None      # injected faults fire once
        finally:
            close = getattr(data_iter, "close", None)
            if close is not None:
                close()
        state = None
        _backoff(restarts, rng, history, sleep, backoff_base, backoff_max,
                 backoff_jitter)


def _agreed(e, policy) -> bool:
    """Whether every rank of ``policy``'s mesh raised ``e`` at the same
    step (always true off a mesh): a fault ``run`` carried
    (:class:`MeshFault`), the plan's (every rank runs the same plan) or a
    non-finite streak (the guard's flag is agreed).  Any other fault may
    be this rank's alone, its peers waiting in a collective it left, so
    the supervisors do not restart on it."""
    from repro_torch.resilience.inject import DeviceLossError, InjectedCrash
    return policy is None or isinstance(
        e, (MeshFault, NonFiniteStreakError, InjectedCrash, DeviceLossError))


def _restart_point(loop_cfg: LoopConfig, policy=None) -> int:
    """The step the next attempt will resume from (newest intact ckpt).
    Pending saves are finished first (on a mesh, on every rank), so it is
    the step the restore will find, the same on every rank."""
    if loop_cfg.ckpt_dir:
        ckpt_lib.settle(policy)
        return ckpt_lib.latest_step(loop_cfg.ckpt_dir) or 0
    return 0


def elastic_restart_on_failure(make_setup, make_data_iter,
                               loop_cfg: LoopConfig, *, factorization,
                               injector=None, max_restarts: int = 3,
                               recoverable=RECOVERABLE,
                               backoff_base: float = 0.5,
                               backoff_max: float = 30.0,
                               backoff_jitter: float = 0.1, seed: int = 0,
                               logger=print, sleep=time.sleep):
    """Mesh-shrinking supervisor, run on every rank of the world: survives
    the permanent loss of a mesh slice.

    Extends :func:`restart_on_failure`'s restore-and-retry posture to
    :class:`~repro_torch.resilience.inject.DeviceLossError`, the fault a
    plain restart cannot fix.  On a device loss (DESIGN §10):

    1. the lost slice's ranks (``launch.mesh.surviving_devices``) leave:
       they return ``(None, history)``; the survivors re-form the world
       over themselves (``launch.mesh.shrink_world``) and take the largest
       legal degraded factorization (``launch.mesh.shrink_factorization``);
    2. lost DATA parallelism folds into gradient accumulation
       (``virtual_dp`` x= fold), so the global batch schedule, and with it
       the loss and every parameter, is bitwise unchanged;
    3. ``make_setup`` rebuilds mesh, state and step (a shared
       :class:`~repro_torch.resilience.inject.FaultInjector` is rebound,
       so fire-once faults stay spent), the newest VERIFIED checkpoint is
       resharded onto the degraded mesh
       (``restore_latest_verified(..., reshard=True)``), and the loop
       resumes.

    ``make_setup(factorization, devices, virtual_dp)`` returns ``(policy,
    parts, make_state, step_fn, poisoned_step_fn)`` (the last may be None);
    ``devices=None`` means every rank of the current world.  Other
    recoverable failures that every rank raised at the same step
    (:func:`_agreed`) restart on the current (possibly degraded) mesh.
    Health adds ``mesh_shrinks`` to the usual counters.
    """
    from repro_torch.launch.mesh import (shrink_factorization, shrink_world,
                                         surviving_devices)
    from repro_torch.resilience.inject import DeviceLossError

    rng = _random.Random(seed)
    history = History()
    restarts = 0
    data_offset = 0
    fact = tuple(factorization)
    vdp = 1
    skel = None     # the state's shapes on the current mesh
    while True:
        policy, parts, make_state, step_fn, poisoned = make_setup(
            fact, None, vdp)
        train_step = (injector.rebind(step_fn, poisoned)
                      if injector is not None else step_fn)
        state, start, skel = _resume(loop_cfg, make_state, skel, history,
                                     logger, policy=policy, parts=parts,
                                     reshard=True)
        data_iter = make_data_iter(start + data_offset)
        try:
            return run(state, train_step, data_iter, loop_cfg, logger=logger,
                       history=history, data_offset=data_offset,
                       policy=policy, parts=parts, recoverable=recoverable)
        except DeviceLossError as e:
            restarts += 1
            history.health["restarts"] += 1
            history.health["mesh_shrinks"] += 1
            survivors = surviving_devices(policy.mesh, e.axis)
            fact, fold = shrink_factorization(fact, e.axis)
            if e.axis == "data":
                vdp *= fold
            want = math.prod(fact)
            state = policy = parts = train_step = skel = None
            if shrink_world(survivors[:want]) is None:
                logger(f"device loss on axis {e.axis!r}: this rank's slice "
                       f"is lost; leaving the mesh")
                return None, history
            logger(f"device loss on axis {e.axis!r}: shrinking to "
                   f"(dp, S, cp, tp, ep) = {fact} over {want} "
                   f"device(s), virtual_dp={vdp} "
                   f"(restart {restarts}/{max_restarts})")
            if restarts >= max_restarts:
                raise
        except recoverable as e:
            if not _agreed(e, policy):
                raise
            restarts += 1
            history.health["restarts"] += 1
            logger(f"failure: {e}; restart {restarts}/{max_restarts}")
            if restarts >= max_restarts:
                raise
        finally:
            close = getattr(data_iter, "close", None)
            if close is not None:
                close()
        state = None
        _backoff(restarts, rng, history, sleep, backoff_base, backoff_max,
                 backoff_jitter)
