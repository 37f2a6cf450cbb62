"""Serving entry point: fresh random init at an architecture's widths, then
batched generation (mirrors ``repro/launch/serve.py``; restoring a
checkpoint is not ported yet).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --prompt-len 1024 --steps 32 --batch 4

Runs on the card (``--device cuda``, the default; raises without one);
``--device cpu`` runs on the host through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the timings; returns the generated
    tokens (on the host) and the timings."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="glm4-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)

    def generator(offset):
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    params = init_params(cfg, generator(0), device)
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
