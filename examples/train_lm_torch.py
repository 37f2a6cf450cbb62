"""Train a ~100M-parameter GLM-family LM with the PyTorch port (mirrors
``examples/train_lm.py``).

End-to-end training run over the port's pieces: the synthetic-but-learnable data
pipeline (prefetching), AdamW under warmup-cosine, and the fault-tolerant
loop with atomic verified checkpoints, auto-resume from the newest verified
one, and the straggler monitor.  Runs on the card by default; ``--device
cpu`` runs on the host through the kernels' plain versions, and ``--tiny``
takes a 2-layer, 64-wide model of the same family for a quick host run.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data import (DataConfig, PrefetchIterator,  # noqa: E402
                              SyntheticLM)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import (LoopConfig, build_train_step,  # noqa: E402
                               init_train_state, restart_on_failure)

# ~100M params: a small GLM-like dense decoder
CFG = ModelConfig(
    name="glm-100m", family="dense",
    num_layers=8, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=8192, mlp_type="swiglu", rope_theta=1e5,
    dtype="float32", remat=False, attn_chunk=128,
)
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=512, attn_chunk=16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_lm_torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(CFG, **TINY) if args.tiny else CFG
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=11))
    opt = make_optimizer("adamw", total_steps=args.steps, base_lr=6e-4)
    step = build_train_step(cfg, opt)

    def make_state():
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
        n = sum(p.numel() for p in params.values())
        print(f"model: {n/1e6:.1f}M params, device={device}")
        return init_train_state(cfg, params, opt)

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=100 if not args.tiny else 2,
                          log_every=10)
    state, hist = restart_on_failure(
        make_state, step, lambda s: PrefetchIterator(data, s), loop_cfg)
    if not hist:
        print(f"nothing to do: the checkpoint is at step {state['step']}")
        return
    first = sum(h["loss"] for h in hist[:5]) / len(hist[:5])
    last = sum(h["loss"] for h in hist[-5:]) / len(hist[-5:])
    print(f"\nloss: first5={first:.3f} -> last5={last:.3f} "
          f"({len(hist)} steps, {sum(h['sec'] for h in hist):.0f}s)")


if __name__ == "__main__":
    main()
