"""Training loop with restarts, NaN-streak rollback and straggler
monitoring (mirrors ``repro/train/loop.py``).

Restart contract: the data pipeline is addressed by step, so a loop that
restarts from a state resumes exactly.  ``restart_on_failure`` wraps the
step loop in a supervised retry (the in-process analogue of a cluster
controller rescheduling a failed job): a declared set of recoverable
exception types, seeded jittered exponential backoff, and NaN-streak
rollback: when the guard skips ``rollback_after_skips`` steps in a row the
poison is persistent, so the supervisor starts again and advances the data
iterator past the poisoned window (``data_offset``: batch ``step + offset``
feeds step ``step``).

Checkpoints are not ported yet (ROADMAP Queue 1 item 10): ``ckpt_dir``
other than None raises ``NotImplementedError``, and every restart starts
again from ``make_state()``.  The mesh-shrinking supervisor
(``elastic_restart_on_failure``) waits for items 6 and 10.

Straggler mitigation: an EWMA step-time monitor flags steps slower than
``factor`` x the moving average.  ``run`` and ``restart_on_failure`` return
a :class:`History` of per-step records whose ``.health`` dict carries the
counters an operator would page on.
"""

from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass

import torch

NO_CKPT = ("checkpoints are not ported yet (ROADMAP Queue 1 item 10, "
           "\"Checkpoint, resilience and elastic recovery\"): use "
           "ckpt_dir=None")


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
    """The reference's loop settings, less the checkpoint cadence
    (``ckpt_every``, ``keep``, ``async_ckpt``), which comes with the
    checkpoints (ROADMAP Queue 1 item 10)."""
    total_steps: int = 100
    ckpt_dir: str | None = None          # not ported yet: must be None
    log_every: int = 10
    fail_at_step: int | None = None      # injected fault: raise at this step
    rollback_after_skips: int | None = None  # NaN-streak rollback threshold


def _sync(t):
    """Wait for the device ``t`` lives on (the step's last kernels)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


def run(state, train_step, data_iter, loop_cfg: LoopConfig, *, logger=print,
        history: History | None = None, data_offset: int = 0):
    """Run the step loop from ``state``; returns (state, history).

    ``data_offset`` shifts the stateless data addressing: step ``i``
    consumes batch ``i + data_offset``.  ``history`` lets the supervisor
    thread one :class:`History` through restarts.  A step's time is the
    host clock from before the step to the end of its last kernel.
    """
    if loop_cfg.ckpt_dir:
        raise NotImplementedError(NO_CKPT)
    monitor = StragglerMonitor()
    if history is None:
        history = History()
    start = int(state["step"])
    streak_first = None
    streak = 0
    for step in range(start, loop_cfg.total_steps):
        data_step, batch = next(data_iter)
        if data_step != step + data_offset:
            raise RuntimeError(f"data iterator at batch {data_step}, loop at "
                               f"step {step} with offset {data_offset}")
        t0 = time.perf_counter()
        if loop_cfg.fail_at_step is not None and step == loop_cfg.fail_at_step:
            raise RuntimeError(f"injected fault at step {step}")
        state, metrics = train_step(state, batch)
        _sync(metrics["loss"])
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
            logger(f"step {step:5d}  non-finite gradients: step SKIPPED "
                   f"(streak {streak})")
            if (loop_cfg.rollback_after_skips
                    and streak >= loop_cfg.rollback_after_skips):
                raise NonFiniteStreakError(streak_first, step, streak)
        else:
            streak = 0
        if step % loop_cfg.log_every == 0 or slow:
            logger(f"step {step:5d}  loss {rec['loss']:.4f}  "
                   f"gnorm {rec['grad_norm']:.3f}  {dt*1e3:.0f} ms"
                   + ("  [STRAGGLER]" if slow else ""))
    return state, history


# The declared recoverable surface: planned crashes and loop faults
# (RuntimeError covers the fail_at_step hook), I/O flakes (OSError), and
# host-side float traps.  Programming errors (TypeError, ValueError,
# KeyError...) stay fatal: restarting can't fix those and the retry would
# loop.  NotImplementedError is a RuntimeError, so the supervisor refuses
# a checkpoint directory before it starts rather than retrying it.
RECOVERABLE = (RuntimeError, OSError, FloatingPointError)


def restart_on_failure(make_state, train_step, make_data_iter,
                       loop_cfg: LoopConfig, *, max_restarts: int = 3,
                       recoverable=RECOVERABLE, backoff_base: float = 0.5,
                       backoff_max: float = 30.0, backoff_jitter: float = 0.1,
                       seed: int = 0, logger=print, sleep=time.sleep):
    """Supervised retry loop: the single-process analogue of a cluster
    restart.

    On a recoverable failure: start again from ``make_state()`` (no
    checkpoint to restore yet), back off with seeded jittered exponential
    delay (``backoff_base * 2^k``, capped at ``backoff_max``), and resume.
    On a :class:`NonFiniteStreakError` (persistent poison): additionally
    advance the stateless data iterator past the poisoned window via
    ``data_offset``.  Raises after ``max_restarts`` recoveries; exception
    types outside ``recoverable`` propagate at once.  Each data iterator is
    closed when its attempt ends.  Returns ``(state, history)``.
    """
    if loop_cfg.ckpt_dir:
        raise NotImplementedError(NO_CKPT)
    rng = _random.Random(seed)
    history = History()
    restarts = 0
    data_offset = 0
    while True:
        state = make_state()
        start = 0
        data_iter = make_data_iter(start + data_offset)
        try:
            return run(state, train_step, data_iter, loop_cfg, logger=logger,
                       history=history, data_offset=data_offset)
        except NonFiniteStreakError as e:
            restarts += 1
            history.health["rollbacks"] += 1
            # the poisoned data window is [first skipped batch, last skipped
            # batch]; replay model state from the restart point but feed it
            # the batches AFTER the window (a pure index shift)
            data_offset = max(data_offset, e.last_step + 1 + data_offset
                              - _restart_point(loop_cfg))
            logger(f"persistent non-finite streak: {e}; rolling back with "
                   f"data_offset={data_offset} "
                   f"(restart {restarts}/{max_restarts})")
            if restarts >= max_restarts:
                raise
        except recoverable as e:
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
        delay = min(backoff_max, backoff_base * (2 ** (restarts - 1)))
        delay *= 1.0 + backoff_jitter * rng.random()
        history.health["backoff_seconds"] += delay
        sleep(delay)


def _restart_point(loop_cfg: LoopConfig) -> int:
    """The step the next attempt will resume from: 0, since there is no
    checkpoint to resume from yet."""
    if loop_cfg.ckpt_dir:
        raise NotImplementedError(NO_CKPT)
    return 0
