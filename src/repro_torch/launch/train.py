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

Without ``--hybrid-mesh`` on more than one device it runs the
reference's production program, ``build_train_step`` under
``Policy(mesh)`` on the ``(n, 1)`` (data, model) mesh (ZeRO-3 over data,
tensor and sequence parallelism over model; ``train/step.py``), one
process per rank: ``--world N`` (default every visible card on
``cuda``, 1 on ``cpu``, the counterpart of
``--xla_force_host_platform_device_count=N``); at world 1 it is the
one-device path.  ``train(cfg, ..., mesh=(dp, tp))`` is the per-rank form
for a caller already inside a world (``chip_smoke.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --world 8 --steps 3

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

The loop is the fault-tolerant one of ``train/loop.py``: atomic verified
checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir`` and resume
from the newest verified one, and ``--fault-plan`` turns on the
deterministic chaos harness (``resilience/inject.py``), e.g.
``--fault-plan poison=5,crash=9,corrupt=bitflip``: step 5's gradients are
NaN-poisoned (the guard skips), step 9 crashes after bit-flipping the
newest checkpoint, and the supervisor quarantines it, falls back and
resumes.  ``--elastic`` (with ``--hybrid-mesh``) survives the loss of a
mesh slice (``shrink=step:axis`` in the plan): the lost ranks leave, the
survivors shrink the mesh, reshard the newest verified checkpoint and fold
lost data parallelism into ``virtual_dp``.  On the hybrid path the
supervisor restarts the whole mesh on the reference's recoverable set
(``RuntimeError``, ``OSError``, ``FloatingPointError``) when every rank
raised the fault at the same step: the plan's faults (every rank runs the
same plan), a non-finite streak, and a fault one rank raised outside the
step (a failed checkpoint write), which the step's guard all-reduce
carries to every rank; any other fault ends the run on every rank
(``launch.mesh.spawn`` stops them).  CP > 1
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
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import init_params, init_pipeline_params
from repro_torch.models.blocks import check_train_policy
from repro_torch.models.convert import to_rank_params
from repro_torch.models.model import (_check_pipelineable,
                                      init_rank_train_params,
                                      shard_train_params)
from repro_torch.optim import make_optimizer
from repro_torch.resilience import FaultInjector, FaultPlan, nan_grad_hook
from repro_torch.sharding import Policy
from repro_torch.train import (RECOVERABLE, LoopConfig,
                               build_hybrid_train_step, build_train_step,
                               elastic_restart_on_failure,
                               hybrid_param_parts, init_train_state,
                               restart_on_failure)
from repro_torch.train.step import sp_state_parts

def _plan(fault_plan):
    return (FaultPlan.parse(fault_plan) if isinstance(fault_plan, str)
            else fault_plan)


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 1e-3,
          seed: int = 0, device=None, max_restarts: int = 3,
          rollback_after_skips: int | None = None, ckpt_dir=None,
          ckpt_every: int = 50, keep: int = 3, fault_plan=None,
          mesh=None, rank_init: bool = False, logger=print):
    """Train ``cfg`` from a random init (or the newest verified checkpoint
    in ``ckpt_dir``) for ``steps`` steps, saving every ``ckpt_every``
    steps and keeping ``keep``; ``fault_plan`` (a ``FaultPlan`` or its CLI
    string) injects its faults.  Returns ``(state, history)``
    (``train/loop.py``).

    ``mesh=(dp, tp)``: this rank's part of the policy train program over a
    (data, model) mesh under ``Policy(mesh)`` (ZeRO-3 over data, tensor
    and sequence parallelism over model), every rank of a world already
    joined calling it together.  The state is this rank's blocks: cut
    from ``init_params(seed)`` on ``device`` (the one-device run's
    values), or with ``rank_init`` drawn on ``device`` alone
    (``models.init_rank_train_params``; no host or card holds the whole
    model).  Checkpoints store each leaf whole and restore each rank's
    blocks (``checkpoint/ckpt.py``); the supervisor restarts the whole
    mesh on the reference's recoverable set, as ``train_hybrid_rank``'s
    does, and only the mesh's first rank damages a checkpoint."""
    device = resolve_device(device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    opt = make_optimizer(cfg.optimizer, total_steps=steps, base_lr=lr)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    policy = parts = None
    supervise = {}
    if mesh is not None:
        policy = Policy(launch_mesh.make_host_mesh(
            tuple(mesh), device=device, all_ranks_group=True))
        check_train_policy(cfg, policy)
        parts = sp_state_parts(cfg, policy, opt)
        supervise = dict(policy=policy, parts=parts, recoverable=RECOVERABLE)
    step = build_train_step(cfg, opt, policy=policy)
    plan = _plan(fault_plan)
    if plan is not None:
        # the poisoned sibling is the same step with the gradient fault
        # hook built in; the injector chooses between them on the host
        poisoned = build_train_step(
            cfg, opt, policy=policy,
            fault_hook=nan_grad_hook(plan.poison_value))
        step = FaultInjector(plan, step, poisoned_step_fn=poisoned,
                             ckpt_dir=ckpt_dir,
                             corrupt_rank=policy is None
                             or dist.get_rank() == 0)

    def make_iter(start):
        return PrefetchIterator(data, start_step=start)

    def make_state():
        if policy is None:
            params = init_params(cfg, torch.Generator(device=device)
                                 .manual_seed(seed), device)
            n = sum(p.numel() for p in params.values())
            logger(f"{cfg.name}: {n/1e6:.1f}M params, device={device}")
            return init_train_state(cfg, params, opt)
        if rank_init:
            params = init_rank_train_params(cfg, policy, seed, device)
        else:
            params = shard_train_params(cfg, init_params(
                cfg, torch.Generator(device=device).manual_seed(seed),
                device), policy)
        n = sum(p.numel() for p in params.values())
        logger(f"{cfg.name}: {n/1e6:.1f}M params on this rank, mesh="
               f"{dict(zip(policy.axis_names, policy.mesh.shape))} (ZeRO-3 "
               f"over data, TP/SP over model), device={device}")
        return init_train_state(cfg, params, opt)

    loop_cfg = LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=ckpt_every, keep=keep, log_every=10,
                          rollback_after_skips=rollback_after_skips)
    return restart_on_failure(make_state, step, make_iter, loop_cfg,
                              max_restarts=max_restarts, logger=logger,
                              **supervise)


def _sp_rank_main(rank, world_mesh, *, cfg, world, **kw):
    """Spawned on every rank by ``train_sp``: the history only."""
    logs = []
    _, hist = train(cfg, mesh=(world, 1), logger=logs.append, **kw)
    return {"history": list(hist), "health": hist.health, "log": logs}


def train_sp(cfg, world: int, *, device=None, timeout_s: float = 1800.0,
             **kw) -> list:
    """Spawn ``world`` ranks on ``device`` (NCCL, one rank per card, for
    ``cuda``; gloo for ``cpu``) and run the policy train program on the
    reference's ``(world, 1)`` mesh on each (``train(..., mesh=)``);
    returns each rank's ``{"history", "health", "log"}``."""
    device = resolve_device(device)
    return launch_mesh.spawn(
        functools.partial(_sp_rank_main, cfg=cfg, world=world,
                          device=device.type, **kw),
        world, device=device.type, timeout_s=timeout_s)


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
    not divide, SSM mixers under CP > 1 (the reference scans each
    sequence shard from zero state, which is not the global scan), and
    under explicit TP (TP > 1) a width the model axis splits and does not
    divide (the stage body cuts d_model, the query and K/V heads and d_ff
    over it); a tied-embedding arch raises as the pipeline cut does."""
    dp, pp, cp, tp, ep = hybrid
    if seq is not None and seq % cp:
        raise SystemExit(f"--seq {seq} not divisible by CP={cp}")
    kinds = {(cfg.mixer_kind(i), cfg.ffn_kind(i))
             for i in range(cfg.block_period)}
    widths = {"d_model": cfg.d_model}
    if any(m == "attn" for m, _ in kinds):
        widths.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    if any(f == "mlp" for _, f in kinds):
        widths["d_ff"] = cfg.d_ff
    bad = {k: v for k, v in widths.items() if v % tp}
    if bad:
        raise SystemExit(
            f"--hybrid-mesh TP={tp}: explicit TP splits {sorted(widths)} of "
            f"{cfg.name} over the model axis; {bad} not divisible by {tp}")
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
                      ckpt_dir=None, ckpt_every: int = 50,
                      fault_plan=None, elastic: bool = False,
                      logger=print):
    """The hybrid run on THIS rank of a world already joined (every rank
    of the factorization ``hybrid`` = (dp, pp, cp, tp, ep) calls it
    together): the mesh, the policy (explicit TP when tp > 1), the step,
    and the supervised loop over this rank's state.  Returns ``(state,
    history, policy)``; after a device loss under ``elastic`` a rank of the
    lost slice returns ``(None, history, None)``.  Each rank initialises
    the global parameters from ``seed`` on the host, keeps only its blocks
    (``convert.to_rank_params``) and moves them to ``device``, so no card
    ever holds the whole model; every rank draws the same global batches
    and cuts its own rows.

    Checkpoints (``ckpt_dir``, every ``ckpt_every`` steps) store each leaf
    whole and restore each rank's blocks (``checkpoint/ckpt.py``).  The
    supervisor restarts on the reference's recoverable set,
    ``(RuntimeError, OSError, FloatingPointError)``, and always the whole
    mesh from one checkpoint, on faults every rank raises at the same
    step: the plan's crash and device loss (``fault_plan``; every rank
    runs the same plan, and only rank 0 damages a checkpoint), a
    non-finite streak (``rollback_after_skips``; the guard's flag is
    agreed over the mesh), an agreed corrupt checkpoint, and a fault one
    rank raised outside the step (a failed checkpoint write), which the
    next step's guard all-reduce carries to every rank
    (``train/loop.py::run``).  Any other fault (outside the set, or raised
    inside a step on one rank) ends the run (``launch.mesh.spawn`` then
    stops every rank): a restart of that rank alone would pair its step
    with its peers' pending one and train the ranks out of step.
    ``elastic`` supervises with
    ``train/loop.py::elastic_restart_on_failure``."""
    check_hybrid(cfg, hybrid, seq)
    device = resolve_device(device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))
    opt = make_optimizer(cfg.optimizer, total_steps=steps, base_lr=lr)
    cfg = dataclasses.replace(cfg, grad_accum=1)
    plan = _plan(fault_plan)
    hook = nan_grad_hook(plan.poison_value) if plan is not None else None
    last = {}

    def make_setup(fact, devices, vdp):
        dp, pp, cp, tp, ep = fact
        mesh = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep,
                                            devices=devices, device=device)
        policy = Policy.for_mesh(mesh, explicit_tp=tp > 1)
        kw = dict(num_microbatches=microbatches, schedule=schedule,
                  virtual_dp=vdp)
        step = build_hybrid_train_step(cfg, policy, opt, **kw)
        poisoned = (build_hybrid_train_step(cfg, policy, opt,
                                            fault_hook=hook, **kw)
                    if hook is not None else None)

        def make_state():
            glob = init_pipeline_params(
                cfg, torch.Generator().manual_seed(seed), pp, "cpu")
            n = sum(p.numel() for p in glob.values())
            params = {k: v.to(device)
                      for k, v in to_rank_params(cfg, policy, glob).items()}
            del glob
            mine = sum(p.numel() for p in params.values())
            logger(f"{cfg.name}: {n/1e6:.1f}M params ({mine/1e6:.1f}M on "
                   f"this rank), mesh="
                   f"{dict(zip(policy.axis_names, mesh.shape))}, "
                   f"virtual_dp={vdp}, device={device}")
            return init_train_state(cfg, params, opt)

        last["policy"] = policy
        return policy, hybrid_param_parts(cfg, policy), make_state, step, \
            poisoned

    def make_iter(start):
        return PrefetchIterator(data, start_step=start)

    loop_cfg = LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                          ckpt_every=ckpt_every, log_every=10,
                          rollback_after_skips=rollback_after_skips)
    injector = (FaultInjector(plan, None, ckpt_dir=ckpt_dir,
                              corrupt_rank=dist.get_rank() == 0)
                if plan is not None else None)
    if elastic:
        state, hist = elastic_restart_on_failure(
            make_setup, make_iter, loop_cfg, factorization=hybrid,
            injector=injector, max_restarts=max_restarts,
            recoverable=RECOVERABLE, logger=logger)
        return state, hist, (last["policy"] if state is not None else None)
    policy, parts, make_state, step, poisoned = make_setup(hybrid, None, 1)
    if injector is not None:
        step = injector.rebind(step, poisoned)
    state, hist = restart_on_failure(
        make_state, step, make_iter, loop_cfg, policy=policy, parts=parts,
        max_restarts=max_restarts, recoverable=RECOVERABLE, logger=logger)
    return state, hist, policy


def _hybrid_rank_main(rank, world_mesh, *, cfg, hybrid, **kw):
    """Spawned on every rank by ``train_hybrid``: the history only."""
    logs = []
    state, hist, _ = train_hybrid_rank(cfg, hybrid, logger=logs.append, **kw)
    return {"history": list(hist), "health": hist.health, "log": logs,
            "left": state is None}


def train_hybrid(cfg, hybrid, *, device=None, timeout_s: float = 1800.0,
                 **kw) -> list:
    """Spawn one process per rank of ``hybrid`` = (dp, pp, cp, tp, ep) on
    ``device`` (NCCL, one rank per card, for ``cuda``; gloo for ``cpu``)
    and run ``train_hybrid_rank`` on each; returns each rank's
    ``{"history", "health", "log", "left"}`` (``left``: the rank's slice
    was lost under ``elastic``)."""
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
    ap.add_argument("--world", type=int, default=None,
                    help="without --hybrid-mesh: run the policy train "
                         "program (ZeRO-3 over data, TP/SP over model) on "
                         "the reference's (WORLD, 1) mesh, one process per "
                         "rank (default: every visible card on cuda, 1 on "
                         "cpu); 1 is the one-device path")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pipeline microbatches per step (hybrid mesh only)")
    ap.add_argument("--schedule", default="1f1b",
                    choices=("1f1b", "fill_drain"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="inject deterministic faults (resilience/inject.py)"
                         ": comma-separated tokens, e.g. 'poison=5,crash=9,"
                         "corrupt=bitflip,slow=4:0.2,seed=1'; keys: poison "
                         "(NaN gradients at steps, '+'-joined), value "
                         "(nan/inf), crash, corrupt (bitflip|truncate the "
                         "newest checkpoint on crash), array (corrupt "
                         "target key substring), slow (step:seconds), "
                         "shrink (step:axis, with --elastic), seed, "
                         "persistent (faults re-fire on replay)")
    ap.add_argument("--elastic", action="store_true",
                    help="mesh-shrinking supervision (DESIGN §10): on a "
                         "simulated device loss (fault-plan key "
                         "'shrink=step:axis') shrink to the largest legal "
                         "degraded factorization, reshard the newest "
                         "verified checkpoint through the Repartition "
                         "plan, fold lost data parallelism into grad "
                         "accumulation (loss-exact), resume; requires "
                         "--hybrid-mesh")
    args = ap.parse_args(argv)
    if args.elastic and not args.hybrid_mesh:
        raise SystemExit("--elastic requires --hybrid-mesh")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    run = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
               seed=args.seed, device=args.device,
               max_restarts=args.max_restarts,
               rollback_after_skips=args.rollback_after_skips,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               fault_plan=args.fault_plan)
    if args.hybrid_mesh:
        hybrid = parse_hybrid(args.hybrid_mesh)
        ranks = train_hybrid(cfg, hybrid, microbatches=args.microbatches,
                             schedule=args.schedule, elastic=args.elastic,
                             **run)
        for line in ranks[0]["log"]:
            print(line)
        state, hist = None, ranks[0]["history"]
        health = ranks[0]["health"]
        where = (f"mesh {','.join(map(str, hybrid))}, {len(ranks)} ranks"
                 + (f", {sum(r['left'] for r in ranks)} left"
                    if any(r["left"] for r in ranks) else ""))
    else:
        world = args.world
        if world is None:
            world = (torch.cuda.device_count()
                     if resolve_device(args.device).type == "cuda" else 1)
        if world > 1:
            ranks = train_sp(cfg, world, **run)
            for line in ranks[0]["log"]:
                print(line)
            state, hist = None, ranks[0]["history"]
            health = ranks[0]["health"]
            where = f"mesh (data, model) = ({world}, 1), {world} ranks"
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
