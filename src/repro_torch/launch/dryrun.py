"""Dry run: trace one step of the port's own programs as one rank of the
production mesh, on ``meta`` tensors, WITHOUT allocating a model byte
(mirrors ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k --multipod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep          # all cells, subprocesses

Where the reference lowers and compiles each cell under GSPMD on 256 or
512 emulated devices and reads XLA's memory and cost analyses, the port
has no compiler to ask: one host process joins a fake world of 256 (or
512) ranks as rank 0 (``launch.mesh.init_fake_world``) and runs the very
program a rank of that mesh runs, on ``meta`` tensors, inside a shape
trace (``roofline/hlo_profile.py``).  The trace sees every aten op, every
hand-written kernel call (``kernels/ops.py``'s meta route, which applies
the card's checks) and every collective (``core/primitives.py``), and it
keeps the high-water mark of live storage bytes.  Eager tracing counts
every layer, so no depth extrapolation is needed.

The programs:

- train: the policy train program, ``train.build_train_step(cfg, opt,
  policy=Policy(mesh, fsdp=True, seq_shard=True))`` (ZeRO-3 over data,
  tensor and sequence parallelism over model, ``cfg.grad_accum``
  microbatches), the reference's ``make_policy`` (``repro/launch/
  dryrun.py:40-43``) on (data, model) = (16, 16), or (pod, data, model) =
  (2, 16, 16) with ``fsdp_over_pod``; each rank's state is its blocks
  (``models.shard_train_params`` of the parameters' shapes) and their
  AdamW (or Adafactor) moments.
- prefill and decode: ``serve.ServeEngine(cfg, params, policy)`` over
  (data, model) = (16, 16) (or (32, 16)) under ``kvdim``, tracing
  ``prefill`` and one ``decode_step`` with a full-length cache, as the
  reference's ``prefill_step`` and ``serve_step``.  A batch the data axis
  does not divide is replicated: every data replica serves it whole, so
  rank 0 runs the program of a (1, 16) mesh.

A cell the port's own checks refuse is written with ``refused`` holding
the port's message, never skipped.  Every number is a bound from shapes
(``"source"``), cached as JSON under ``results/dryrun_torch/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

SERVE_MESH = {False: (16, 16), True: (32, 16)}
# what the port's checks raise for a program it does not run:
# ``blocks.check_train_policy`` and ``blocks.check_serve_policy``
# (NotImplementedError); anything else fails the cell
REFUSALS = (NotImplementedError,)


def trace_serve(cfg, *, batch: int, prompt_len: int, policy=None,
                kind: str = "both", max_seq: int | None = None):
    """Trace ``ServeEngine``'s ``prefill`` of a (batch, prompt_len) prompt
    (``kind`` "prefill"), one ``decode_step`` against a full cache of
    ``prompt_len`` positions ("decode"), or both in order ("both": the
    first decode step after the prompt), on ``meta`` (this rank's shards
    under ``policy``).  ``max_seq``: the engine's cache length, by
    default the least the program needs.  Returns the trace; the
    parameters (and the decode cache) count as live from the start."""
    from repro_torch.launch.specs import param_specs
    from repro_torch.models import init_cache, shard_params
    from repro_torch.roofline.hlo_profile import Trace
    from repro_torch.serve import ServeEngine
    params = param_specs(cfg)
    if policy is not None:
        params = shard_params(cfg, params, policy)
    # decode alone attends a full cache: the new token takes its last slot
    max_seq = max_seq or prompt_len + (kind != "decode")
    engine = ServeEngine(cfg, params, policy, max_seq=max_seq,
                         batch_size=batch)
    tokens = torch.empty((batch, prompt_len), dtype=torch.long,
                         device="meta")
    tr = Trace().adopt(params)
    if kind == "decode":
        cache = init_cache(cfg, batch, max_seq, device="meta",
                           policy=policy)
        tr.adopt(cache)
    rows = batch
    if policy is not None and policy.active_data_axis is not None:
        rows //= policy.dp_size
    with tr:
        if kind in ("prefill", "both"):
            _, cache = engine.prefill(tokens)
        if kind in ("decode", "both"):
            tok = torch.empty((rows, 1), dtype=torch.long, device="meta")
            engine.decode_step(cache, tok, prompt_len if kind == "both"
                               else max_seq - 1)
    return tr


def make_policy(mesh):
    """The reference's dry-run policy (``repro/launch/dryrun.py:40-43``):
    ZeRO-3 and sequence sharding on, fsdp over the pod axis too on the
    multi-pod mesh."""
    from repro_torch.sharding import Policy
    multi = "pod" in mesh.mesh_dim_names
    return Policy(mesh, pod_axis="pod" if multi else None, fsdp=True,
                  fsdp_over_pod=multi, seq_shard=True)


def trace_train(cfg, *, batch: int, seq: int, policy=None):
    """Trace one train step on ``meta``: ``build_train_step`` on one
    device (``policy`` None, as ``launch.train.train``), or the policy
    train program (``build_train_step(..., policy=)``, ``cfg.grad_accum``
    microbatches) on this rank's blocks of ``policy``'s mesh.  The state,
    the parameters and optimizer moments of ``init_train_state``, counts
    as live from the start.  Returns the trace."""
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.model import DTYPES, shard_train_params
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline.hlo_profile import Trace
    from repro_torch.train import build_train_step, init_train_state
    if policy is None:
        cfg = dataclasses.replace(cfg, grad_accum=1)
    opt = make_optimizer(cfg.optimizer, total_steps=10)
    step = build_train_step(cfg, opt, policy=policy)
    params = param_specs(cfg)
    if policy is not None:
        params = shard_train_params(cfg, params, policy)
    state = init_train_state(cfg, params, opt)
    batch_ = {k: torch.empty((batch, seq), dtype=torch.long, device="meta")
              for k in ("tokens", "labels")}
    if cfg.frontend != "none":
        # the stub frontends' embeddings take the tokens' place
        del batch_["tokens"]
        batch_["embeds"] = torch.empty((batch, seq, cfg.d_model),
                                       dtype=DTYPES[cfg.dtype], device="meta")
    tr = Trace().adopt(state["params"], state["opt"])
    with tr:
        step(state, batch_)
    return tr


def program(cell_kind: str, multi_pod: bool, cfg, batch: int) -> str:
    if cell_kind == "train":
        mesh = ("(pod, data, model) = (2, 16, 16), ZeRO-3 over pod and data"
                if multi_pod else "(data, model) = (16, 16), ZeRO-3 over "
                "data")
        return (f"policy train step {mesh}, TP/SP over model, "
                f"{max(cfg.grad_accum, 1)} microbatch(es), remat "
                f"{'on' if cfg.remat else 'off'}")
    dp, tp = SERVE_MESH[multi_pod]
    rep = "" if batch % dp == 0 else ", batch replicated over data"
    return f"ServeEngine (data, model) = ({dp}, {tp}), kvdim{rep}"


def _memory(tr, argument_bytes: int) -> dict:
    out = max(tr.live_bytes - argument_bytes, 0)
    return {"argument_GiB": argument_bytes / 2**30,
            "output_GiB": out / 2**30,
            "temp_GiB": (tr.peak_bytes - argument_bytes) / 2**30,
            "alias_GiB": 0.0,
            "peak_per_device_GiB": tr.peak_bytes / 2**30}


def summarize(tr, cfg, shape_name: str, chips: int) -> dict:
    """The result keys of a trace: memory, collectives, kernel calls and
    the roofline."""
    from repro_torch.roofline.analysis import (HBM_BYTES, analyze,
                                               collective_bytes)
    records = tr.records
    coll = collective_bytes(records)
    coll["method"] = "eager trace of one rank (every layer counted)"
    coll["c10d_ops"] = sum(tr.c10d.values())
    kernels, routes = {}, {}
    for rec in records:
        if rec.kind == "kernel":
            kernels[rec.op] = kernels.get(rec.op, 0) + 1
            by = routes.setdefault(rec.op, {})
            by[rec.route] = by.get(rec.route, 0) + 1
    roof = analyze(records, cfg, shape_name, chips)
    return {"memory": _memory(tr, tr.argument_bytes),
            "fits": tr.peak_bytes <= HBM_BYTES,
            "collectives": coll, "kernel_calls": kernels,
            "kernel_routes": routes,
            "roofline": dict(roof.as_dict(), t_bound_s=roof.t_bound)}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True, keep_trace: bool = False) -> dict:
    """Trace one (arch x shape x mesh) cell as rank 0 of a fake world and
    return its result dict (``refused`` set where the port's checks
    refuse the program).  Every mesh here has pp = 1: one stage, whose
    program rank 0 runs."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.blocks import check_train_policy
    from repro_torch.roofline.analysis import SOURCE
    from repro_torch.sharding import Policy

    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    B, S = cell.global_batch, cell.seq_len
    chips = SERVE_MESH[multi_pod][0] * SERVE_MESH[multi_pod][1]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "program": program(cell.kind, multi_pod, cfg, B),
        "params_B": cfg.param_count() / 1e9,
        "active_params_B": cfg.active_param_count() / 1e9,
        "source": SOURCE, "refused": None,
    }
    launch_mesh.init_fake_world(0, chips)
    t0 = time.time()
    try:
        if cell.kind == "train":
            mesh = launch_mesh.make_production_mesh(
                multi_pod=multi_pod, device="meta", all_ranks_group=True)
            policy = make_policy(mesh)
            check_train_policy(cfg, policy)
            tr = trace_train(cfg, batch=B, seq=S, policy=policy)
        else:
            dp, tp = SERVE_MESH[multi_pod]
            if B % dp:
                dp = 1
            mesh = launch_mesh.make_host_mesh((dp, tp), device="meta")
            policy = Policy.for_mesh(mesh, kv_layout="kvdim")
            tr = trace_serve(cfg, batch=B, prompt_len=S, policy=policy,
                             kind=cell.kind)
    except REFUSALS as e:
        result["refused"] = f"{type(e).__name__}: {e}"
        tr = None
    finally:
        dist.destroy_process_group()
    result["trace_s"] = round(time.time() - t0, 1)
    if tr is None:
        result.update(memory=None, fits=None, collectives=None,
                      roofline=None)
    else:
        result.update(summarize(tr, cfg, shape_name, chips))
        if keep_trace:
            result["_trace"] = tr.records
    if verbose:
        print(json.dumps({k: v for k, v in result.items()
                          if k != "_trace"}, indent=2))
    return result


def world1_cell(kind: str, arch: str, layers: int, batch: int,
                seq: int) -> dict:
    """One program on ONE device at a caller's depth and shape (no mesh,
    no fake world): ``kind`` "serve" traces ``ServeEngine``'s prefill of a
    (batch, seq) prompt and one decode step, "train" one step of
    ``build_train_step`` (``launch.train.train``'s).  The dry run of a
    cell the card also runs, so the two can be held side by side."""
    from repro_torch.configs import get_config
    from repro_torch.roofline.analysis import SOURCE
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    t0 = time.time()
    if kind == "serve":
        tr = trace_serve(cfg, batch=batch, prompt_len=seq)
        shape = "prefill_32k"
    else:
        tr = trace_train(cfg, batch=batch, seq=seq)
        shape = "train_4k"
    out = {"kind": kind, "arch": arch, "layers": layers, "batch": batch,
           "seq": seq, "source": SOURCE}
    out.update(summarize(tr, cfg, shape, 1))
    # the model-flops terms are the reference's shape cells', not this one
    for key in ("model_flops_global", "useful_flops_ratio", "mfu_bound"):
        out["roofline"].pop(key)
    out["trace_s"] = round(time.time() - t0, 1)
    return out


def mesh_cell(arch: str, layers: int, batch: int, seq: int,
              mesh_shape: tuple, rank: int = 0, kind: str = "train",
              kv_layout: str = "kvdim", max_seq: int | None = None) -> dict:
    """One program of ``arch`` cut to ``layers`` at a caller's (data,
    model) ``mesh_shape``, batch and sequence, traced by ``rank`` of a fake
    world of that size, so the card's run of the same cell can be held
    against it (its peak, collectives, kernel calls).  ``kind`` "train":
    one step of the policy train program (``Policy(mesh)``, the
    reference's defaults); "serve": ``ServeEngine``'s prefill of a
    (batch, seq) prompt and the first decode step after it under
    ``Policy.for_mesh(mesh, kv_layout=)``, the engine's cache ``max_seq``
    long (``trace_serve``).  Ranks differ where the model axis does not
    divide a width (the first hold one head, column or channel more)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.roofline.analysis import SOURCE
    from repro_torch.sharding import Policy
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    chips = mesh_shape[0] * mesh_shape[1]
    launch_mesh.init_fake_world(rank, chips)
    t0 = time.time()
    try:
        mesh = launch_mesh.make_host_mesh(mesh_shape, device="meta",
                                          all_ranks_group=True)
        if kind == "train":
            tr = trace_train(cfg, batch=batch, seq=seq, policy=Policy(mesh))
        else:
            tr = trace_serve(cfg, batch=batch, prompt_len=seq,
                             policy=Policy.for_mesh(mesh,
                                                    kv_layout=kv_layout),
                             max_seq=max_seq)
    finally:
        dist.destroy_process_group()
    out = {"kind": kind, "arch": arch, "layers": layers, "batch": batch,
           "seq": seq, "mesh": list(mesh_shape), "rank": rank,
           "source": SOURCE}
    if kind != "train":
        out.update(kv_layout=kv_layout, max_seq=max_seq)
    out.update(summarize(tr, cfg, "train_4k" if kind == "train"
                         else "prefill_32k", chips))
    for key in ("model_flops_global", "useful_flops_ratio", "mfu_bound"):
        out["roofline"].pop(key)
    out["trace_s"] = round(time.time() - t0, 1)
    return out


def cell_path(arch, shape_name, multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    d = os.path.join(RESULTS_DIR, mesh)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


def main(argv=None):
    from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, \
        get_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="run every applicable cell in subprocesses")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.sweep:
        failures = []
        meshes = [False, True] if args.both_meshes else [args.multipod]
        for arch in ARCH_IDS:
            for shape in applicable_shapes(get_config(arch)):
                for mp in meshes:
                    out = cell_path(arch, shape, mp)
                    if os.path.exists(out) and not args.force:
                        print(f"skip (cached): {out}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape]
                    if mp:
                        cmd.append("--multipod")
                    print(">>", " ".join(cmd), flush=True)
                    try:
                        r = subprocess.run(cmd, timeout=1800,
                                           stdout=subprocess.DEVNULL)
                        ok = r.returncode == 0
                    except subprocess.TimeoutExpired:
                        ok = False
                    if not ok:
                        failures.append((arch, shape, mp))
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("sweep complete")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --sweep)")
    if args.shape not in applicable_shapes(get_config(args.arch)):
        print(f"SKIP: {args.arch} x {args.shape} not applicable "
              f"(long_500k is sub-quadratic-only; see DESIGN.md)")
        return
    result = lower_cell(args.arch, args.shape, multi_pod=args.multipod)
    with open(cell_path(args.arch, args.shape, args.multipod), "w") as f:
        json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
