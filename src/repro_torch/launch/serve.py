"""Serving entry point: the newest checkpoint's parameters (``--ckpt-dir``)
or a fresh random init at an architecture's widths, then batched
generation (mirrors ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --prompt-len 1024 --steps 32 --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --prompt-len 2048 --steps 32 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --ckpt-dir /tmp/ckpt --steps 4

``--ckpt-dir`` restores the params of the newest checkpoint there (the
reference's format, written by either package's train loop or
``checkpoint.save``) onto the chosen device and prints ``restored params
from step N``; without a checkpoint there it initialises fresh.

Runs on the card (``--device cuda``, the default; raises without one);
``--device cpu`` runs on the host through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main(argv=None, *, cfg=None) -> dict:
    """Parse ``argv``, serve, print the timings; returns the generated
    tokens (on the host), the timings and the engine.  ``cfg``, where
    given, replaces ``--arch``/``--reduced`` (a caller's config, e.g. a
    depth cut whose checkpoint is to be served)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)

    def generator(offset):
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    params = init_params(cfg, generator(0), device)
    if args.ckpt_dir and ckpt_lib.latest_step(args.ckpt_dir):
        state, step = ckpt_lib.restore(
            args.ckpt_dir, like={"params": params, "step": 0, "opt": None})
        print(f"restored params from step {step}")
        params = state["params"]
    engine = ServeEngine(cfg, params, max_seq=args.prompt_len + args.steps + 8,
                         batch_size=args.batch)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=generator(1), device=device)
    out = engine.generate(prompt, steps=args.steps,
                          greedy=args.temperature == 0.0,
                          generator=generator(2),
                          temperature=max(args.temperature, 1e-3))
    st = engine.stats
    result = {
        "tokens": out.cpu(),
        "prefill_s": st["prefill_s"],
        "decode_s": st["decode_s"],
        "prefill_tok_s": args.batch * args.prompt_len / st["prefill_s"],
        "decode_tok_s": args.batch * args.steps / st["decode_s"],
        "logits_finite": st["logits_finite"],
        "engine": engine,
    }
    print(f"generated {tuple(out.shape)} on {device}: prefill "
          f"{args.batch}x{args.prompt_len} tokens in {st['prefill_s']:.4f} s "
          f"({result['prefill_tok_s']:.1f} tok/s), decode "
          f"{args.batch}x{args.steps} tokens in {st['decode_s']:.4f} s "
          f"({result['decode_tok_s']:.1f} tok/s)")
    for row in range(min(2, args.batch)):
        print(f" stream {row}:", result["tokens"][row, :16].tolist())
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
