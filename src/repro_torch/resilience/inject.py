"""Deterministic fault injection for training-loop chaos tests (mirrors
``repro/resilience/inject.py``, DESIGN §9).

A :class:`FaultPlan` is a seeded, declarative schedule of faults (the
reference's ``--fault-plan`` grammar); :class:`FaultInjector` wraps a train
step and fires them at exact step numbers.

Fire-once semantics live on the host: the injector keeps a spent-set and
chooses between two step functions, the clean step and a poisoned sibling
built by the same function with ``fault_hook=nan_grad_hook(...)`` (batches
are integer token ids, so a NaN cannot enter through the data).  A replay
after a rollback therefore runs clean, which the chaos test's exact-golden
property rests on.

Under the hybrid step every rank runs the same plan, so a crash or a
device loss fires on every rank at the same step, before that step's
collectives.  :func:`corrupt_checkpoint` models a torn write or a bad
sector: a seeded bit-flip or truncation of one array file past the npy
header, which the same seed places on the same byte of the same file as
the reference does.
"""

from __future__ import annotations

import json
import os
import random
import time
from dataclasses import dataclass, field

import numpy as np


class InjectedCrash(RuntimeError):
    """A planned process 'crash', recoverable by the supervisor."""


class DeviceLossError(RuntimeError):
    """A simulated loss of one mesh-axis slice of devices (DESIGN §10).

    Carries the mesh axis whose last slice 'died'.  The plain supervisor
    treats it as recoverable by a restart; the ELASTIC supervisor shrinks
    the mesh factorization (``launch/mesh.py``), reshards the latest
    verified checkpoint (``restore_resharded``) and folds the lost data
    parallelism into gradient accumulation (``virtual_dp``)."""

    def __init__(self, axis: str, step: int | None = None):
        self.axis = axis
        self.step = step
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"injected device loss on mesh axis {axis!r}{at}")


@dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded schedule of training faults.

    ``poison_grads_at``: steps whose gradients are NaN/Inf-poisoned (the
    step runs the poisoned variant; the guard should skip).  ``crash_at``:
    steps at which :class:`InjectedCrash` is raised before the step runs;
    with ``corrupt_on_crash`` the newest checkpoint is damaged first.
    ``slow_at``: steps delayed by ``slow_seconds``.  ``shrink_at``:
    ``((step, axis), ...)`` device losses.  ``once=True`` (default) makes
    every fault fire exactly once across restarts and replays; ``once=False``
    re-fires on every pass over the step."""
    seed: int = 0
    poison_grads_at: tuple = ()
    poison_value: float = float("nan")
    crash_at: tuple = ()
    corrupt_on_crash: bool = False
    corrupt_mode: str = "bitflip"          # or "truncate"
    corrupt_array: str | None = None       # key substring; default: a params leaf
    slow_at: tuple = ()
    slow_seconds: float = 0.0
    shrink_at: tuple = ()                  # ((step, axis), ...) device losses
    once: bool = True

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse the ``--fault-plan`` CLI syntax: comma-separated
        ``key=value`` tokens, several steps joined with ``+``, e.g.
        ``poison=3+4,crash=9,corrupt=bitflip,slow=4:0.2,seed=1,persistent``.
        Keys: ``poison``, ``value`` (``nan``/``inf``/float), ``crash``,
        ``corrupt`` (bitflip|truncate, implies corrupt-on-crash), ``array``
        (corrupt-target key substring), ``slow`` (``step:seconds``),
        ``shrink`` (``step:axis``, e.g. ``shrink=6:data``), ``seed``,
        ``persistent`` (faults re-fire)."""
        kw: dict = {}
        for tok in filter(None, (t.strip() for t in spec.split(","))):
            if tok == "persistent":
                kw["once"] = False
                continue
            if "=" not in tok:
                raise ValueError(f"bad fault-plan token {tok!r}")
            k, v = tok.split("=", 1)
            if k == "poison":
                kw["poison_grads_at"] = tuple(int(s) for s in v.split("+"))
            elif k == "value":
                kw["poison_value"] = float(v)
            elif k == "crash":
                kw["crash_at"] = tuple(int(s) for s in v.split("+"))
            elif k == "corrupt":
                if v not in ("bitflip", "truncate"):
                    raise ValueError(f"corrupt mode {v!r} not bitflip|truncate")
                kw["corrupt_on_crash"] = True
                kw["corrupt_mode"] = v
            elif k == "array":
                kw["corrupt_array"] = v
            elif k == "slow":
                step, _, sec = v.partition(":")
                kw["slow_at"] = tuple(int(s) for s in step.split("+"))
                kw["slow_seconds"] = float(sec) if sec else 0.1
            elif k == "shrink":
                losses = []
                for item in v.split("+"):
                    step, _, axis = item.partition(":")
                    if not axis:
                        raise ValueError(
                            f"shrink fault {item!r} needs step:axis "
                            f"(e.g. shrink=6:data)")
                    losses.append((int(step), axis))
                kw["shrink_at"] = tuple(losses)
            elif k == "seed":
                kw["seed"] = int(v)
            else:
                raise ValueError(f"unknown fault-plan key {k!r}")
        return FaultPlan(**kw)


def nan_grad_hook(value: float = float("nan")):
    """A ``grads -> grads`` hook poisoning one gradient element: element 0
    of the first leaf in the reference's leaf order (its flat names sorted
    as ``jax.tree_util`` sorts the nested keys).  Pass as ``fault_hook=`` to
    ``build_train_step`` or ``build_hybrid_train_step`` to get the poisoned
    variant; under the hybrid step each rank poisons its own first leaf,
    and the guard's one-bit all-reduce still skips the step on every
    rank."""
    def hook(grads):
        first = min(grads, key=lambda k: tuple(k.split(".")))
        g = grads[first].clone()
        g.view(-1)[0] = value
        return dict(grads, **{first: g})
    return hook


def poison_batch(batch, value: float = float("nan")):
    """Host-side batch poisoner: sets element 0 of every FLOAT leaf of a
    flat ``{name: array}`` batch.  Token-id batches (integer leaves) have
    nowhere to hold a NaN: inject at the gradients with
    :func:`nan_grad_hook` instead.  Returns ``(batch, n_poisoned)``."""
    out, n = {}, 0
    for k, a in batch.items():
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            a = a.copy()
            a.ravel()[0] = value
            n += 1
        out[k] = a
    return out, n


def corrupt_checkpoint(ckpt_dir: str, step: int | None = None, *,
                       array: str | None = None, mode: str = "bitflip",
                       seed: int = 0) -> str:
    """Damage one array file of a finalized checkpoint; returns its path.

    ``step=None`` targets the newest checkpoint; ``array`` selects the
    first manifest leaf whose key contains it (default: the first
    ``params`` leaf).  ``bitflip`` flips one seeded byte strictly past the
    npy header; ``truncate`` halves the file.  Either way ``restore``'s
    per-array checksum catches it (``CorruptCheckpointError``)."""
    from repro_torch.checkpoint import ckpt as ckpt_lib
    if step is None:
        step = ckpt_lib.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = array if array is not None else "params"
    entry = next((e for e in manifest["leaves"] if want in e["key"]),
                 manifest["leaves"][0])
    fpath = os.path.join(path, entry["file"])
    size = os.path.getsize(fpath)
    if mode == "truncate":
        with open(fpath, "r+b") as f:
            f.truncate(size // 2)
    elif mode == "bitflip":
        # past the npy header block (128-byte aligned): silent at parse
        # time, so only the checksum can see it
        lo = min(256, size - 1)
        pos = random.Random(seed).randrange(lo, size)
        with open(fpath, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0x40]))
    else:
        raise ValueError(f"corrupt mode {mode!r} not bitflip|truncate")
    return fpath


@dataclass
class FaultInjector:
    """Host-side wrapper turning a :class:`FaultPlan` into live faults.

    Callable as a train step: ``injector(state, batch, **kw)``, the
    keywords passed on to the step it runs.  Reads the step
    number from ``state["step"]`` (an int), consults the plan, and either
    sleeps (slow), raises :class:`DeviceLossError` (shrink) or
    :class:`InjectedCrash` (crash, damaging the newest checkpoint first
    when the plan says so), or runs the poisoned step instead of the clean
    one.  The spent-set lives here, so replays after a rollback run clean:
    share ONE injector across supervisor restarts.

    ``corrupt_rank``: on a mesh, the checkpoint is damaged only where this
    is True (one rank, the writer: the caller passes ``rank == 0``), after
    ``wait_pending()``; the barrier that ``restore_latest_verified`` passes
    on every rank before it lists the checkpoints follows."""
    plan: FaultPlan
    step_fn: object
    poisoned_step_fn: object | None = None
    ckpt_dir: str | None = None
    corrupt_rank: bool = True
    _spent: set = field(default_factory=set)

    def _fires(self, kind: str, step: int, at: tuple) -> bool:
        if step not in at:
            return False
        if self.plan.once:
            if (kind, step) in self._spent:
                return False
            self._spent.add((kind, step))
        return True

    def rebind(self, step_fn, poisoned_step_fn=None):
        """Swap in rebuilt step functions, keeping the spent-set (the
        elastic supervisor rebuilds the step for the degraded mesh)."""
        self.step_fn = step_fn
        if poisoned_step_fn is not None:
            self.poisoned_step_fn = poisoned_step_fn
        return self

    def __call__(self, state, batch, **kw):
        step = int(state["step"])
        if self._fires("slow", step, self.plan.slow_at):
            time.sleep(self.plan.slow_seconds)
        for at, axis in self.plan.shrink_at:
            if step == at and self._fires(f"shrink:{axis}", step, (at,)):
                raise DeviceLossError(axis, step)
        if self._fires("crash", step, self.plan.crash_at):
            if self.plan.corrupt_on_crash and self.ckpt_dir:
                from repro_torch.checkpoint import ckpt as ckpt_lib
                ckpt_lib.wait_pending()      # corrupt a FINALIZED checkpoint
                if self.corrupt_rank:
                    corrupt_checkpoint(self.ckpt_dir,
                                       array=self.plan.corrupt_array,
                                       mode=self.plan.corrupt_mode,
                                       seed=self.plan.seed)
            raise InjectedCrash(f"injected crash at step {step}")
        if self._fires("poison", step, self.plan.poison_grads_at):
            if self.poisoned_step_fn is None:
                raise ValueError(
                    "FaultPlan poisons gradients but no poisoned_step_fn was "
                    "built (pass fault_hook=nan_grad_hook(...) to build_train_step)")
            return self.poisoned_step_fn(state, batch, **kw)
        return self.step_fn(state, batch, **kw)
