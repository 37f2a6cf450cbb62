"""Serve a small LM with batched requests through the PyTorch port: prefill
+ streaming decode (mirrors ``examples/serve_lm.py``).

Demonstrates the serving engine over the unified model: batched prompt
prefill writes the KV caches, then lockstep decode appends tokens for the
whole batch.  Greedy decode on a model trained for a few steps on the
modular-drift task recovers the drift pattern.  Runs on the card by
default; ``--device cpu`` runs on the host through the kernels' plain
versions.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import build_train_step, init_train_state  # noqa: E402

CFG = ModelConfig(
    name="serve-demo", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
    d_ff=512, vocab_size=512, mlp_type="swiglu", rope_theta=1e5,
    dtype="float32", remat=False, attn_chunk=64,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = CFG
    # quick-train so generation is meaningful
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=8, seed=5))
    opt = make_optimizer("adamw", total_steps=150, base_lr=2e-3)
    step = build_train_step(cfg, opt)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    state = init_train_state(cfg, params, opt)
    for s in range(150):
        state, m = step(state, data.batch(s))
    print(f"trained 150 steps, final loss {float(m['loss']):.3f}")

    # batched serving
    engine = ServeEngine(cfg, state["params"], max_seq=96, batch_size=4)
    prompt = torch.from_numpy(data.batch(999)["tokens"][:4, :16]).long()
    out = engine.generate(prompt.to(device), steps=16, greedy=True).cpu()

    drift = 1 + (5 % (cfg.vocab_size - 1))
    expect = (prompt[:, -1:] + drift * (1 + torch.arange(16))[None, :]
              ) % cfg.vocab_size
    acc = float((out == expect).float().mean())
    print(f"batched generation: {out.shape[0]} streams x {out.shape[1]} "
          f"tokens")
    print("first stream :", out[0].tolist())
    print("expected     :", expect[0].tolist())
    print(f"pattern accuracy: {acc:.2%}")
    return acc


if __name__ == "__main__":
    main()
