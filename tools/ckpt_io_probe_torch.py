"""The card machine's checkpoint I/O rates, and whether one bf16 train step
repeats bitwise from the same state: the numbers phase 14 of
``chip_smoke.py`` (``resilience``) was sized and predicted from.

Prints one JSON line per measurement: the filesystem of the checkout and
its free bytes; a 4 GiB fp32 tensor's device-to-host copy into fresh
pageable and into pinned memory, zlib's crc32 over it on one thread, its
``np.save`` with and without ``fsync``, ``np.load`` and the host-to-device
copy; then glm4-9b at full width cut to 2 layers (bf16, B 4, S 1024): one
step, then the next step run twice from copies of that state, with and
without ``torch.use_deterministic_algorithms``, and the leaves that differ;
last, the embedding lookup as advanced indexing (``table[tokens]``, whose
backward is an accumulating ``index_put_``) against ``F.embedding`` (the
port's ``models.model.embed_lookup``), in turns in this one process: the
lookup's forward and backward at glm4-9b's train shape (CUDA events), and
the 2-layer train step from one state (host clock, synchronised).

    python3 tools/ckpt_io_probe_torch.py
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import build_train_step, init_train_state  # noqa: E402


def emit(**row):
    print(json.dumps(row), flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def io_rates(out: Path):
    a = torch.randn(1024, 1024, 1024, device="cuda")     # 4 GiB fp32
    n = a.numel() * a.element_size()
    torch.cuda.synchronize()
    h, dt = timed(a.cpu)
    emit(d2h_pageable_gbps=n / dt / 1e9)
    pinned = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
    _, dt = timed(lambda: (pinned.copy_(a), torch.cuda.synchronize()))
    emit(d2h_pinned_gbps=n / dt / 1e9)
    arr = h.numpy()
    _, dt = timed(lambda: zlib.crc32(arr))
    emit(crc32_one_thread_gbps=n / dt / 1e9)

    def save_fsync():
        with open(out / "x.npy", "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
    _, dt = timed(save_fsync)
    emit(write_fsync_gbps=n / dt / 1e9)
    _, dt = timed(lambda: np.save(out / "y.npy", arr))
    emit(write_gbps=n / dt / 1e9)
    back, dt = timed(lambda: np.load(out / "y.npy"))
    emit(read_gbps=n / dt / 1e9)
    _, dt = timed(lambda: (torch.from_numpy(back).to("cuda"),
                           torch.cuda.synchronize()))
    emit(h2d_pageable_gbps=n / dt / 1e9)


def clone(state):
    return {"params": {k: v.clone() for k, v in state["params"].items()},
            "opt": {"m": {k: v.clone() for k, v in state["opt"]["m"].items()},
                    "v": {k: v.clone() for k, v in state["opt"]["v"].items()},
                    "count": state["opt"]["count"]},
            "step": state["step"], "skipped_steps": state["skipped_steps"]}


def differ(a, b):
    return ([k for k in a["params"]
             if not torch.equal(a["params"][k], b["params"][k])]
            + [f"{m}.{k}" for m in ("m", "v") for k in a["opt"][m]
               if not torch.equal(a["opt"][m][k], b["opt"][m][k])])


def repeatability():
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    opt = make_optimizer(cfg.optimizer, total_steps=6, base_lr=1e-3)
    step = build_train_step(cfg, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                  global_batch=4, seed=0))
    for deterministic in (False, True):
        torch.use_deterministic_algorithms(deterministic)
        state = init_train_state(cfg, init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), opt)
        state, _ = step(state, data.batch(0))
        base = clone(state)
        del state
        s1, m1 = step(clone(base), data.batch(1))
        s2, m2 = step(clone(base), data.batch(1))
        bad = differ(s1, s2)
        emit(deterministic_algorithms=deterministic,
             losses=[repr(float(m1["loss"])), repr(float(m2["loss"]))],
             differ=bad[:20], n_differ=len(bad))
        del s1, s2, base
        torch.cuda.empty_cache()


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def embedding_ab(rounds: int = 5):
    from repro_torch.models import model as model_mod
    lookups = {"index": lambda table, tokens: table[tokens],
               "F.embedding": lambda table, tokens: torch.nn.functional
               .embedding(tokens, table)}
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                                  global_batch=4, seed=0))
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=g,
                        device="cuda").to(torch.bfloat16).requires_grad_()
    tokens = torch.as_tensor(data.batch(0)["tokens"], device="cuda").long()
    dy = torch.randn(*tokens.shape, cfg.d_model, generator=g, device="cuda",
                     dtype=torch.bfloat16)

    def fwd_bwd(lookup):
        table.grad = None
        lookup(table, tokens).backward(dy)

    ms = {k: [] for k in lookups}
    for name, lookup in lookups.items():
        for _ in range(3):
            fwd_bwd(lookup)
    for r in range(rounds):
        for name in (lookups if r % 2 == 0 else reversed(list(lookups))):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(10):
                fwd_bwd(lookups[name])
            b.record()
            torch.cuda.synchronize()
            ms[name].append(a.elapsed_time(b) / 10)
    emit(embedding_fwd_bwd_ms={k: _median(v) for k, v in ms.items()},
         runs=ms, table=list(table.shape), tokens=list(tokens.shape))
    del table, dy
    torch.cuda.empty_cache()

    opt = make_optimizer(cfg.optimizer, total_steps=6, base_lr=1e-3)
    step = build_train_step(cfg, opt)
    state = init_train_state(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), opt)
    state, _ = step(state, data.batch(0))
    base = clone(state)
    del state
    step_s, losses = {k: [] for k in lookups}, {}
    keep = model_mod.embed_lookup
    try:
        for r in range(rounds):
            for name in (lookups if r % 2 == 0
                         else reversed(list(lookups))):
                model_mod.embed_lookup = lookups[name]
                s = clone(base)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, m = step(s, data.batch(1))
                losses[name] = repr(float(m["loss"]))
                step_s[name].append(time.perf_counter() - t0)
                del s
    finally:
        model_mod.embed_lookup = keep
    emit(train_step_2_layers_s={k: _median(v) for k, v in step_s.items()},
         runs=step_s, losses=losses)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ckpt_io_probe_torch: no card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    out = ROOT / "build" / "io_probe"
    out.mkdir(parents=True, exist_ok=True)
    usage = shutil.disk_usage(out)
    emit(path=str(out), free_bytes=usage.free, df=subprocess.run(
        ["df", "-T", str(out)], capture_output=True, text=True,
        timeout=60).stdout.splitlines()[-1], cpus=os.cpu_count())
    try:
        io_rates(out)
    finally:
        shutil.rmtree(out)
    torch.cuda.empty_cache()
    # cuBLAS needs this before its first call to be deterministic on demand
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    repeatability()
    torch.use_deterministic_algorithms(False)
    embedding_ab()


if __name__ == "__main__":
    main()
