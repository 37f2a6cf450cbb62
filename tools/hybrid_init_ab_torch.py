"""A/B of the hybrid run's init on one NVIDIA card: the global parameter
tree built on the host (``launch/train.py::train_hybrid_rank`` as it
stands) against the same tree built on the card (patched in here).
glm4-9b bf16 at full width cut to 8 layers, mesh (1, 1, 1), B 4, S 1024,
M 4, 5 steps, then one step split by CUDA events (``chip_smoke.
hybrid_split``), in the order host, card, card, host, each in a fresh
NCCL rank.  One JSON line per run.

    python3 tools/hybrid_init_ab_torch.py
"""
import dataclasses
import functools
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402


def run(rank, world_mesh, *, card_init):
    torch.backends.cuda.matmul.allow_tf32 = False
    if card_init:
        orig = launch_train.init_pipeline_params

        def on_card(cfg, gen, pp, device):
            return orig(cfg, torch.Generator(device="cuda").manual_seed(0),
                        pp, "cuda")
        launch_train.init_pipeline_params = on_card
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=8)
    torch.cuda.reset_peak_memory_stats()
    state, hist, policy = launch_train.train_hybrid_rank(
        cfg, (1, 1, 1, 1, 1), steps=5, batch=4, seq=1024, microbatches=4,
        schedule="1f1b", lr=1e-3, seed=0, device="cuda",
        logger=lambda *a: None)
    secs = sorted(r["sec"] for r in hist[1:])
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                  global_batch=4, seed=0))
    _, split = cs.hybrid_split(cfg, policy, state, data.batch(5), 5)
    return {"card_init": card_init, "median_ms": (secs[1] + secs[2]) / 2e-3,
            "step_ms": [r["sec"] * 1e3 for r in hist],
            "peak": torch.cuda.max_memory_allocated(),
            "losses": [r["loss"] for r in hist], "split": split}


if __name__ == "__main__":
    smi = cs.phase_device()
    cs.phase_build()
    for card_init in (False, True, True, False):
        out = launch_mesh.spawn(functools.partial(run, card_init=card_init),
                                1, device="cuda", timeout_s=600)[0]
        print(json.dumps({"ab_init": out, "nvidia_smi": smi}), flush=True)
