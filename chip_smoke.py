"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card and hold
each hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

0. device: require CUDA; print the card's name and power limit.
1. build: compile the CUDA sources with nvcc (Triton compiles on launch).
2. kernels: flash attention (CUDA) and RMSNorm (Triton) against their plain
   versions on the card at glm4-9b shapes, ragged lengths included; then
   the kernel's, the plain version's and a library call's times at the
   serving shape, beside the bound the card's data sheet gives.
3. parity: glm4-9b at full width cut to 2 layers, fp32, served on the card
   (kernels) and on the host (plain versions): logits and KV caches within
   1e-3, identical greedy tokens.
4. serve: the full 40-layer glm4-9b in bf16 through
   ``repro_torch.launch.serve.main`` (batch 4, prompt 1024, 32 steps), with
   the kernels' launch counts read around that run.
5. decode share: one decode step of that model timed eagerly and replayed
   from a CUDA graph, to show how much of an eager step the device is busy.

Kernel times are device times: the calls are replayed from a CUDA graph,
so the host's launch cost is not in them.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``.  The weights are random, from a seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCH = "glm4-9b"
SERVE_ARGS = ["--arch", ARCH, "--batch", "4", "--prompt-len", "1024",
              "--steps", "32"]
# Dense peaks from NVIDIA's data sheets: (memory bytes/s, bf16 tensor FLOP/s).
PEAKS = {"H100 SXM": (3.35e12, 989e12), "H100 PCIe": (2.0e12, 756e12),
         "H100 NVL": (3.9e12, 835e12)}
# The reference's own pins (tests/test_kernels.py:36-38, 147).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
NORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
PARITY_TOL = 1e-3


def emit(**row):
    print(json.dumps(row), flush=True)


def peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return f"H100 {key}", PEAKS[f"H100 {key}"]
    return "H100 SXM", PEAKS["H100 SXM"]


def cuda_ms(fn, iters=20):
    """Mean device milliseconds of one call of ``fn``: ``iters`` calls are
    captured in one CUDA graph and replayed between two CUDA events, so the
    host's cost of launching them is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up (compile, allocate) uncaptured
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, tol):
    """|got - want| <= tol + tol |want| everywhere; returns the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > tol + tol * want.abs()).sum())
    emit(phase="check", case=name, max_abs_err=float(err.max()), tol=tol,
         mismatches=bad)
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {bad} elements outside tolerance {tol}")
    return float(err.max())


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    table, _ = peaks(name)
    emit(phase="device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         peaks=table)
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text().strip().splitlines()
        emit(phase="build", lib=name, seconds=secs,
             ptxas=[ln for ln in log if "registers" in ln or "spill" in ln])


def phase_kernels():
    """Hold both kernels against their plain versions; time them at the
    serving shape.  Returns the kernels' rows (launches filled in later)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    H, KH, hd = 32, 2, 128
    for B, S in ((2, 512), (1, 2048), (2, 200)):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q = randn((B, S, H, hd), dtype, gen)
                k = randn((B, S, KH, hd), dtype, gen)
                v = randn((B, S, KH, hd), dtype, gen)
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ref.attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                check_close(f"flash B={B} S={S} {dtype} causal={causal}",
                            got, want, FLASH_TOL[dtype])
    d = 4096
    for rows in (4, 4096, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((rows, d), dtype, gen)
            w = 1.0 + 0.1 * randn((d,), torch.float32, gen)
            got = ops.rmsnorm(x, w)
            want = ref.rmsnorm_ref(x, w)
            torch.cuda.synchronize()
            check_close(f"rmsnorm rows={rows} d={d} {dtype}", got, want,
                        NORM_TOL[dtype])

    _, (bw, flops) = peaks(torch.cuda.get_device_name(0))
    bf16 = torch.bfloat16
    B, S = 4, 1024
    q, k, v = (randn((B, S, n, hd), bf16, gen) for n in (H, KH, KH))
    err = check_close("flash serving shape", ops.flash_attention(q, k, v),
                      ref.attention_ref(q, k, v), FLASH_TOL[bf16])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    work = 4 * B * H * hd * (S * (S + 1) // 2)   # causal (q, k) pairs
    flash = {
        "name": "flash_attention", "route": "cuda", "impl": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:69",
        "tpu": "kernels/flash_attention.py::flash_attention_fwd",
        "shape": f"q ({B},{S},{H},{hd}) k/v ({B},{S},{KH},{hd}) bf16 causal",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.flash_attention(q, k, v)),
        "plain_ms": cuda_ms(lambda: ref.attention_ref(q, k, v)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bytes": nbytes, "flops": work,
        "bytes_ms": nbytes / bw * 1e3, "flops_ms": work / flops * 1e3,
    }

    x = randn((B * S, d), bf16, gen)
    w = 1.0 + 0.1 * randn((d,), torch.float32, gen)
    w_lib = w.to(bf16)   # F.rms_norm takes its weight in x's dtype
    err = check_close("rmsnorm serving shape", ops.rmsnorm(x, w),
                      ref.rmsnorm_ref(x, w), NORM_TOL[bf16])
    nbytes = 2 * x.numel() * 2 + w.numel() * 4
    work = 4 * x.numel()
    norm = {
        "name": "rmsnorm", "route": "triton", "impl": "triton",
        "source": "src/repro_torch/kernels/rmsnorm.py",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "tpu": "kernels/rmsnorm.py::rmsnorm_fwd",
        "shape": f"x ({B * S},{d}) bf16, w ({d},) fp32",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.rmsnorm(x, w), iters=100),
        "plain_ms": cuda_ms(lambda: ref.rmsnorm_ref(x, w), iters=100),
        "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), w_lib, 1e-6),
                              iters=100),
        "bytes": nbytes, "flops": work,
        "bytes_ms": nbytes / bw * 1e3, "flops_ms": work / flops * 1e3,
    }
    rows = [flash, norm]
    for row in rows:
        row["bound_ms"] = max(row["bytes_ms"], row["flops_ms"])
        row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["flops_ms"]
                           else "operations")
        emit(phase="timing", **row)
    return rows


def phase_parity():
    """fp32 glm4-9b at full width, 2 layers: card (kernels) vs host (plain)."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=2, dtype="float32")
    B, S, steps = 2, 200, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    gpu = ServeEngine(cfg, params, max_seq=S + steps + 8, batch_size=B)
    cpu = ServeEngine(cfg, {k: t.cpu() for k, t in params.items()},
                      max_seq=S + steps + 8, batch_size=B)
    logits_g, cache_g = gpu.prefill(prompt)
    logits_c, cache_c = cpu.prefill(prompt.cpu())
    check_close("parity prefill logits", logits_g.cpu(), logits_c, PARITY_TOL)
    for name in cache_c:
        check_close(f"parity cache {name}", cache_g[name].cpu(),
                    cache_c[name], PARITY_TOL)
    tok_g = gpu.generate(prompt, steps).cpu()
    tok_c = cpu.generate(prompt.cpu(), steps)
    same = bool(torch.equal(tok_g, tok_c))
    emit(phase="parity", greedy_tokens_equal=same, steps=steps,
         tokens=tok_g[0].tolist())
    if not same:
        raise AssertionError(f"greedy tokens differ: card {tok_g.tolist()} "
                             f"host {tok_c.tolist()}")


def phase_serve(smi):
    """The full bf16 model through the CLI's main(): a warm-up run, then
    the measured run with the launch counts read around it."""
    cfg = get_config(ARCH)
    serve.main(SERVE_ARGS[:-1] + ["2"])           # warm-up: 2 decode steps
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    res = serve.main(SERVE_ARGS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = int(SERVE_ARGS[-1])
    tokens = res["tokens"]
    emit(phase="serve", arch=ARCH, layers=cfg.num_layers, dtype="bfloat16",
         batch=4, prompt_len=1024, steps=steps,
         prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         prefill_tok_s=res["prefill_tok_s"], decode_tok_s=res["decode_tok_s"],
         peak_mem_bytes=peak, launches=launches, nvidia_smi=smi)
    if not res["logits_finite"]:
        raise AssertionError("non-finite logits")
    if tokens.shape != (4, steps) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"tokens out of range: {tokens.tolist()}")
    want = {"flash_attention": cfg.num_layers,
            "rmsnorm": (2 * cfg.num_layers + 1) * (1 + steps)}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    return launches


def phase_decode_share(smi):
    """One bf16 decode step of the full model, run eagerly (host clock,
    synchronised) and replayed from a CUDA graph (device time only): the
    device's busy share of an eager step is their ratio."""
    cfg = get_config(ARCH)
    B, S = 4, 1024
    gen = torch.Generator(device="cuda").manual_seed(3)
    engine = ServeEngine(cfg, init_params(cfg, gen, "cuda"), max_seq=S + 8,
                         batch_size=B)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    _, cache = engine.prefill(prompt)
    tok = prompt[:, -1:]

    def step():
        return engine.decode_step(cache, tok, S)

    iters = 10
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / iters
    device_ms = cuda_ms(step, iters=iters)
    emit(phase="decode_share", batch=B, cache_len=S, eager_step_ms=eager_ms,
         device_step_ms=device_ms, device_busy_share=device_ms / eager_ms,
         nvidia_smi=smi)


def main():
    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    launches = phase_serve(smi)
    phase_decode_share(smi)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "impl", "source", "replaces", "tpu", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
