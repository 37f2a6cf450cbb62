"""Training entry point on one device (mirrors the path of
``repro/launch/train.py`` without ``--hybrid-mesh``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
        --reduced --device cpu --steps 20 --batch 8 --seq 128

Random init from ``--seed``, ``SyntheticLM`` batches, AdamW (or the
config's optimizer) under a warmup-cosine schedule, the non-finite guard
and the supervised loop of ``train/loop.py``.  Runs on the card
(``--device cuda``, the default; raises without one); ``--device cpu``
runs on the host through the kernels' plain versions.  ``train()`` is the
same path for a caller with a ``ModelConfig`` of its own (for example one
cut in depth).

Not ported yet, each exits naming its ROADMAP Queue 1 item:
``--hybrid-mesh`` (items 5-7), ``--elastic`` (items 6 and 10),
``--fault-plan`` and ``--ckpt-dir`` (item 10).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.optim import make_optimizer
from repro_torch.train import (LoopConfig, build_train_step,
                               init_train_state, restart_on_failure)

NOT_PORTED = {
    "hybrid_mesh": "--hybrid-mesh needs the mesh, the pipeline and context "
                   "parallelism (ROADMAP Queue 1 items 5-7)",
    "elastic": "--elastic needs the hybrid mesh and checkpoints (ROADMAP "
               "Queue 1 items 6 and 10)",
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
    for flag in ("--hybrid-mesh", "--fault-plan", "--ckpt-dir"):
        ap.add_argument(flag, default=None, help="not ported yet")
    ap.add_argument("--elastic", action="store_true", help="not ported yet")
    args = ap.parse_args(argv)
    for key, why in NOT_PORTED.items():
        if getattr(args, key):
            raise SystemExit(why)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    state, hist = train(cfg, steps=args.steps, batch=args.batch,
                        seq=args.seq, lr=args.lr, seed=args.seed,
                        device=args.device, max_restarts=args.max_restarts,
                        rollback_after_skips=args.rollback_after_skips)
    health = " ".join(f"{k}={v:.2f}" if isinstance(v, float) else f"{k}={v}"
                      for k, v in hist.health.items())
    print(f"done: final loss {hist[-1]['loss']!r} over {len(hist)} steps  "
          f"[{health}]")
    return state, hist


if __name__ == "__main__":
    main(sys.argv[1:])
