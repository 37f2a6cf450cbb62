"""Training entry point (mirrors ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --reduced --device cpu --steps 20 --batch 8 --seq 128

Random init from ``--seed``, ``SyntheticLM`` batches, AdamW (or the
config's optimizer) under a warmup-cosine schedule, the non-finite guard
and the supervised loop of ``train/loop.py``.  Runs on the card
(``--device cuda``, the default; raises without one); ``--device cpu``
runs on the host through the kernels' plain versions.  ``train()`` is the
same path for a caller with a ``ModelConfig`` of its own (for example one
cut in depth).

Hybrid DP x pipe x ctx x TP x EP (DESIGN §5, §6, §8): ``--hybrid-mesh
DP,PP,CP,TP,EP`` (or DP,PP,CP,TP with EP = 1, or DP,PP,TP with CP = EP =
1) runs the scheduled pipeline executor over a (data, pipe, model) mesh,
(data, pipe, ctx, model) when CP > 1, or (data, pipe, ctx, model, ep)
when EP > 1, one process per rank, each holding only its stage's
parameters, its TP shard and its block of experts.  CP > 1 shards every
microbatch's sequence over the ctx axis and rings attention over it
(``core/ring_attention.py``); MoE FFNs dispatch their tokens over the ep
axis:

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --reduced --device cpu --hybrid-mesh 2,2,1,2,1 --microbatches 4 \
        --steps 3 --batch 16 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --hybrid-mesh 2,1,2,2 --microbatches 4 --steps 3 \
        --batch 16 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \
        --reduced --device cpu --hybrid-mesh 2,1,1,1,4 --microbatches 2 \
        --steps 3 --batch 16 --seq 16

``--device cuda`` runs one NCCL rank per card (the world may not exceed
the card count); ``--device cpu`` spawns gloo ranks.  ``train_hybrid_rank``
is the per-rank path for a caller already inside a world (``chip_smoke.py``).
Not ported yet, each exits naming its ROADMAP Queue 1 item:
``--elastic``, ``--fault-plan`` and ``--ckpt-dir`` (item 10).  CP > 1
refuses SSM mixers (the reference scans each sequence shard from zero
state) and a ``--seq`` it does not divide.  Explicit
TP (TP > 1) takes MoE FFNs only behind attention mixers, as the
reference: jamba's sit behind SSM mixers, so it runs at TP = 1.  Tied-embedding archs (mamba2-370m, phi4-mini)
raise as the pipeline cut does in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import init_params, init_pipeline_params
from repro_torch.models.convert import to_rank_params
from repro_torch.models.model import _check_pipelineable
from repro_torch.optim import make_optimizer
from repro_torch.sharding import Policy
from repro_torch.train import (LoopConfig, build_hybrid_train_step,
                               build_train_step, init_train_state,
                               restart_on_failure)

NOT_PORTED = {
    "elastic": "--elastic needs checkpoints and the mesh-shrinking "
               "supervisor (ROADMAP Queue 1 item 10)",
    "fault_plan": "--fault-plan needs resilience/inject.py (ROADMAP Queue 1 "
                  "item 10)",
    "ckpt_dir": "--ckpt-dir needs checkpoint/ckpt.py (ROADMAP Queue 1 "
                "item 10)",
}


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          seed: int = 0, device=None, max_restarts: int = 3,
          rollback_after_skips: int | None = None, logger=print):
    """Train ``cfg`` from a random init for ``steps`` steps; returns
    ``(state, history)`` (``train/loop.py``)."""
    device = resolve_device(device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    opt = make_optimizer(cfg.optimizer, total_steps=steps, base_lr=lr)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    step = build_train_step(cfg, opt)

    def make_iter(start):
        return PrefetchIterator(data, start_step=start)

    def make_state():
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(seed), device)
        n = sum(p.numel() for p in params.values())
        logger(f"{cfg.name}: {n/1e6:.1f}M params, device={device}")
        return init_train_state(cfg, params, opt)

    loop_cfg = LoopConfig(total_steps=steps, log_every=10,
                          rollback_after_skips=rollback_after_skips)
    return restart_on_failure(make_state, step, make_iter, loop_cfg,
                              max_restarts=max_restarts, logger=logger)


def parse_hybrid(spec: str) -> tuple:
    """``DP,PP,CP,TP,EP`` (or ``DP,PP,CP,TP``, or ``DP,PP,TP``) as a
    5-tuple."""
    parts = [int(x) for x in spec.split(",")]
    if len(parts) == 3:          # DP,PP,TP form
        parts = parts[:2] + [1] + parts[2:]
    if len(parts) == 4:          # DP,PP,CP,TP form
        parts = parts + [1]
    if len(parts) != 5:
        raise SystemExit("--hybrid-mesh wants DP,PP,CP,TP,EP "
                         "(or DP,PP,CP,TP / DP,PP,TP)")
    return tuple(parts)


def check_hybrid(cfg, hybrid, seq: int | None = None):
    """Refuse what the hybrid path cannot run: a sequence the ctx axis does
    not divide, and SSM mixers under CP > 1 (the reference scans each
    sequence shard from zero state, which is not the global scan); a
    tied-embedding arch raises as the pipeline cut does."""
    dp, pp, cp, tp, ep = hybrid
    if seq is not None and seq % cp:
        raise SystemExit(f"--seq {seq} not divisible by CP={cp}")
    ssm = sorted({cfg.mixer_kind(i) for i in range(cfg.block_period)}
                 - {"attn"})
    if cp > 1 and ssm:
        raise SystemExit(
            f"--hybrid-mesh CP={cp} with {cfg.name}'s {'/'.join(ssm)} "
            f"mixers is refused: the reference scans each sequence shard "
            f"from zero state, which is not the global scan (run CP = 1)")
    _check_pipelineable(cfg)


def train_hybrid_rank(cfg, hybrid, *, steps: int, batch: int, seq: int,
                      microbatches: int = 4, schedule: str = "1f1b",
                      lr: float = 1e-3, seed: int = 0, device=None,
                      max_restarts: int = 3,
                      rollback_after_skips: int | None = None,
                      logger=print):
    """The hybrid run on THIS rank of a world already joined (every rank
    of the factorization ``hybrid`` = (dp, pp, cp, tp, ep) calls it
    together): the mesh, the policy (explicit TP when tp > 1), the step,
    and the supervised loop over this rank's state.  Returns ``(state,
    history, policy)``.  Each rank initialises the global parameters from
    ``seed`` on the host, keeps only its blocks (``convert.to_rank_params``)
    and moves them to ``device``, so no card ever holds the whole model;
    every rank draws the same global batches and cuts its own rows.

    Only a non-finite streak restarts the run (``rollback_after_skips``):
    its flag is agreed over the mesh, so every rank rolls back at the same
    step.  Any other fault is raised on the rank that saw it and ends the
    run (``launch.mesh.spawn`` then stops every rank): a restart of that
    rank alone would pair its step 0 with its peers' pending step and
    train the ranks out of step.  Restarting the whole mesh needs ROADMAP
    Queue 1 item 10."""
    check_hybrid(cfg, hybrid, seq)
    device = resolve_device(device)
    dp, pp, cp, tp, ep = hybrid
    mesh = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep, device=device)
    policy = Policy.for_mesh(mesh, explicit_tp=tp > 1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    opt = make_optimizer(cfg.optimizer, total_steps=steps, base_lr=lr)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    step = build_hybrid_train_step(cfg, policy, opt,
                                   num_microbatches=microbatches,
                                   schedule=schedule)

    def make_iter(start):
        return PrefetchIterator(data, start_step=start)

    def make_state():
        glob = init_pipeline_params(cfg, torch.Generator().manual_seed(seed),
                                    pp, "cpu")
        n = sum(p.numel() for p in glob.values())
        params = {k: v.to(device)
                  for k, v in to_rank_params(cfg, policy, glob).items()}
        del glob
        mine = sum(p.numel() for p in params.values())
        logger(f"{cfg.name}: {n/1e6:.1f}M params ({mine/1e6:.1f}M on this "
               f"rank), mesh={dict(zip(policy.axis_names, mesh.shape))}, "
               f"device={device}")
        return init_train_state(cfg, params, opt)

    loop_cfg = LoopConfig(total_steps=steps, log_every=10,
                          rollback_after_skips=rollback_after_skips)
    state, hist = restart_on_failure(make_state, step, make_iter, loop_cfg,
                                     max_restarts=max_restarts,
                                     recoverable=(), logger=logger)
    return state, hist, policy


def _hybrid_rank_main(rank, world_mesh, *, cfg, hybrid, **kw):
    """Spawned on every rank by ``train_hybrid``: the history only."""
    logs = []
    _, hist, _ = train_hybrid_rank(cfg, hybrid, logger=logs.append, **kw)
    return {"history": list(hist), "health": hist.health, "log": logs}


def train_hybrid(cfg, hybrid, *, device=None, timeout_s: float = 1800.0,
                 **kw) -> list:
    """Spawn one process per rank of ``hybrid`` = (dp, pp, cp, tp, ep) on
    ``device`` (NCCL, one rank per card, for ``cuda``; gloo for ``cpu``)
    and run ``train_hybrid_rank`` on each; returns each rank's
    ``{"history", "health", "log"}``."""
    check_hybrid(cfg, hybrid, kw.get("seq"))
    device = resolve_device(device)
    return launch_mesh.spawn(
        functools.partial(_hybrid_rank_main, cfg=cfg, hybrid=hybrid,
                          device=device.type, **kw),
        math.prod(hybrid), device=device.type, timeout_s=timeout_s)


def main(argv=None):
    """Parse ``argv``, train, print the final loss and the health counters;
    returns ``(state, history)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-flash", action="store_true",
                    help="accepted for the reference's CLI; the port's train "
                         "attention always goes through kernels.ops."
                         "flash_attention (the kernel on the card, its plain "
                         "version on the host)")
    ap.add_argument("--rollback-after-skips", type=int, default=None,
                    help="NaN-streak threshold: after this many consecutive "
                         "guard-skipped steps, start again and advance the "
                         "data stream past the poisoned window")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--hybrid-mesh", default=None, metavar="DP,PP,CP,TP,EP",
                    help="run the hybrid executor on a (data, pipe, ctx, "
                         "model, ep) mesh with this factorization, one "
                         "process per rank (a 4-value DP,PP,CP,TP form is "
                         "accepted with EP=1, a 3-value DP,PP,TP form with "
                         "CP=EP=1); CP > 1 rings attention over the "
                         "sequence shards and needs --seq divisible by CP")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pipeline microbatches per step (hybrid mesh only)")
    ap.add_argument("--schedule", default="1f1b",
                    choices=("1f1b", "fill_drain"))
    for flag in ("--fault-plan", "--ckpt-dir"):
        ap.add_argument(flag, default=None, help="not ported yet")
    ap.add_argument("--elastic", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    for key, why in NOT_PORTED.items():
        if getattr(args, key):
            raise SystemExit(why)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    run = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               seed=args.seed, device=args.device,
               max_restarts=args.max_restarts,
               rollback_after_skips=args.rollback_after_skips)
    if args.hybrid_mesh:
        hybrid = parse_hybrid(args.hybrid_mesh)
        ranks = train_hybrid(cfg, hybrid, microbatches=args.microbatches,
                             schedule=args.schedule, **run)
        for line in ranks[0]["log"]:
            print(line)
        state, hist = None, ranks[0]["history"]
        health = ranks[0]["health"]
        where = f"mesh {','.join(map(str, hybrid))}, {len(ranks)} ranks"
    else:
        state, hist = train(cfg, **run)
        health, where = hist.health, "one device"
    health = " ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in health.items())
    print(f"done: final loss {hist[-1]['loss']!r} over {len(hist)} steps "
          f"({where})  [{health}]")
    return state, hist


if __name__ == "__main__":
    main(sys.argv[1:])
