"""Faults planted under a run's timed path, for the readings a cell's limits
are held against (``control.py``) and for the tests that see ``correct``
come out false (``test_bench_faults.py``).

A run's ``faults`` maps where a fault is planted to one of these: ``step``
wraps the train step, ``rank`` runs on each rank before its world is
joined, ``engine`` patches the serving engine.  Each is a module-level
function, so that it reaches the ranks of a spawned mesh.
"""

from __future__ import annotations

import copy


def unchanged(step):
    """A train step that returns its state unchanged."""
    def broken(state, batch):
        _, met = step(copy.deepcopy(state), batch)
        return state, met
    return broken


def half_batch(step):
    """A train step on the first half of the batch's rows, its mean taken
    over those."""
    def broken(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(state, {k: a[:rows] for k, a in batch.items()})
    return broken


def no_exchange():
    """The exchange between chips left out: every reduce-scatter of the
    program's primitives (ZeRO-3's gradient blocks, the sequence-parallel
    sums) hands each rank its own block of its own contribution,
    unsummed."""
    import torch.distributed as dist
    from repro_torch.core import primitives as prim

    def local(out, inp, group=None, **kw):
        out.copy_(inp.chunk(dist.get_world_size(group))[dist.get_rank(group)])

    prim._REDUCE_SCATTER = local


def altered_token(engine):
    """Every served token altered where it is picked: the pick reads the
    logits shifted by one place."""
    pick = engine._pick

    def broken(logits, *args):
        return pick(logits.roll(1, dims=-1), *args)

    engine._pick = broken
    return engine
