"""What every kind of cell shares: the manifest and the files a cell is
made of, found by name; the phase clock; the profiled stretch and its
reading (device busy time, the top device operations, the idle gaps by
what the host was doing); the record of kernel calls; the comparison's
numbers beside their limits.

A cell ``<cell>`` of ``BENCHMARK.json`` names a configuration (its file in
``configs/``) and a traffic mix (``traffic/<traffic>.json``); the cell's
own file ``workloads/<cell>.json`` holds its mesh, the deployment it
stands for and the limits of its comparison.  The traffic file's ``kind``
picks the window loop, ``kinds/<kind>.py``; each per-layer metric is read
by ``metrics/<metric>.py``.  A new cell, traffic mix or metric is a new
file and a new entry, never an edit.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """The module in ``path``, loaded under ``name`` (the file's stem)."""
    spec = importlib.util.spec_from_file_location(name or path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(name: str, man: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, with its files read."""
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"],
                config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH / "traffic" /
                                  f"{entry['traffic']}.json"),
                workload=load_json(BENCH / "workloads" / f"{name}.json"))


def cell_metrics(name: str, trace: bool, man: dict | None = None) -> list:
    """The manifest's entries of the metrics a run of cell ``name``
    reports: with ``trace`` the per-layer ones, else the end-to-end ones;
    a metric with ``workloads`` only in those cells."""
    man = man or manifest()
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def kind_module(kind: str):
    return importlib.import_module(f"kinds.{kind}")


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")
                       .replace("-", "_"))


@dataclass
class Run:
    """One run's arguments: ``t0`` is the process's start on the host
    clock, ``device`` a ``torch.device``."""
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    tmp: Path
    faults: dict = field(default_factory=dict)


SPAWN_TIMEOUT_S = 1100


def world_size(cell: Cell) -> int:
    return math.prod(cell.workload["mesh"])


def on_ranks(fn, cell: Cell, run: Run, **kw) -> list:
    """``fn(rank, mesh, cell=, run=, **kw)`` on every rank of the cell's
    (data, model) mesh, one process a card (the port's ``launch.mesh.
    spawn``, NCCL on cards, gloo on the host), the results in rank order;
    each rank's ``run.device`` is its card.  A mesh of one rank runs in
    this process, with ``mesh`` None."""
    world = world_size(cell)
    if world == 1:
        return [fn(0, None, cell=cell, run=run, **kw)]
    from repro_torch.launch import mesh as launch_mesh
    return launch_mesh.spawn(functools.partial(fn, cell=cell, run=run, **kw),
                             world, device=run.device.type,
                             timeout_s=SPAWN_TIMEOUT_S)


def rank_run(run: Run, rank: int) -> Run:
    """``run`` on rank ``rank``'s card (card r for rank r)."""
    import torch
    if run.device.type != "cuda":
        return run
    return dataclasses.replace(run, device=torch.device("cuda", rank))


def cell_devices(cell: Cell, run: Run) -> list:
    """The cards of the cell, which the reference spreads its layers over
    once the program has left them."""
    import torch
    if run.device.type != "cuda":
        return [run.device]
    return [torch.device("cuda", r) for r in range(world_size(cell))]


class Stages:
    """Set-up's stages on the host clock, in seconds from the process's
    start, for standard error: where a slow set-up spent its time."""

    def __init__(self, t0: float):
        self.t0, self.marks = t0, []

    def __call__(self, name: str):
        self.marks.append([name, now() - self.t0])


PROGRAM_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size", "rope_theta", "mlp_type",
                "tie_embeddings", "ssm_state", "ssm_expand", "ssm_head_dim",
                "conv_kernel", "dtype")


def program_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file: the port's entry
    for ``program`` with every size the file states."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(conf["program"]),
                               **{k: conf[k] for k in PROGRAM_KEYS
                                  if k in conf})


class fp32:
    """Full float32 matmuls (no TF32) while the reference runs."""

    def __enter__(self):
        import torch
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


# ---------------------------------------------------------------------------
# Phases on the device clock, kernel calls, the profiled stretch
# ---------------------------------------------------------------------------

class PhaseClock:
    """The train step's ``phase_hook``: while ``on``, a CUDA event as each
    part of the step starts; ``close()`` ends the step and returns each
    part's milliseconds."""

    def __init__(self):
        self.on = False
        self.marks = []

    def __call__(self, kind):
        if self.on:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((kind, ev))

    def close(self) -> dict:
        self("end")
        self.marks[-1][1].synchronize()
        out = {}
        for (kind, a), (_, b) in zip(self.marks, self.marks[1:]):
            out[kind] = out.get(kind, 0.0) + a.elapsed_time(b)
        self.marks = []
        return out


class CallRecord:
    """A shape trace for the program's registry (``repro_torch.tracing``):
    every hand-written kernel call with its inputs' shapes and dtype and
    its route.  The costs the program attaches are ignored: the benchmark
    counts its own."""

    def __init__(self):
        self.calls = []

    def add(self, kind, op, ins, outs, **kw):
        if kind == "kernel":
            self.calls.append({"name": op, "route": kw.get("route"),
                               "shapes": [tuple(t.shape) for t in ins],
                               "dtype": str(ins[0].dtype)})

    def __enter__(self):
        from repro_torch import tracing
        tracing.TRACES.append(self)
        return self

    def __exit__(self, *exc):
        from repro_torch import tracing
        tracing.TRACES.remove(self)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "bench.stretch"


def profile_stretch(fn, tmp: Path, rank: int = 0) -> dict:
    """Run ``fn`` (which ends in a device synchronise) under
    ``torch.profiler`` with the program's kernel calls recorded, and read the trace: the stretch's span on the host
    (``window_us``), the device operations in it and the host operations,
    each ``(name, start_us, dur_us)``.  The trace file is written to
    ``tmp``, under the ``rank``'s name, and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with CallRecord() as rec:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(SPAN):
                fn()
                torch.cuda.synchronize()
    path = tmp / f"stretch_trace.{rank}.json"
    prof.export_chrome_trace(str(path))
    events = load_json(path)["traceEvents"]
    path.unlink()
    span = next(e for e in events if e.get("name") == SPAN
                and e.get("cat") == "user_annotation")
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", "?"), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            device.append(item)
        elif e.get("cat") in HOST_CATS and e.get("name") != SPAN:
            host.append(item)
    return {"window_us": (w0, w1), "device": device, "host": host,
            "calls": rec.calls}


def merged_busy(device, w0: float, w1: float) -> list:
    """The device's busy intervals inside [w0, w1], merged."""
    spans = sorted((max(s, w0), min(s + d, w1)) for _, s, d in device
                   if s + d > w0 and s < w1)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(stretch: dict) -> float:
    w0, w1 = stretch["window_us"]
    return sum(b - a for a, b in merged_busy(stretch["device"], w0, w1)) / 1e6


def window_seconds(stretch: dict) -> float:
    w0, w1 = stretch["window_us"]
    return (w1 - w0) / 1e6


def device_seconds(stretches: list) -> dict:
    """The result's ``busy_s`` and ``window_s``: the mean over the chips'
    stretches (one a rank)."""
    n = len(stretches)
    return {"busy_s": sum(map(busy_seconds, stretches)) / n,
            "window_s": sum(map(window_seconds, stretches)) / n}


def kernel_seconds(stretch: dict, names) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(d for n, _, d in stretch["device"]
               if any(k in n for k in names)) / 1e6


def stretches(readings: dict, kind: str) -> list:
    """The traced stretches of a run of ``kind``, one a rank; [] for
    another kind or an untraced run."""
    if readings.get("kind") != kind:
        return []
    return readings.get("stretches") or []


def roofline_share(readings: dict, kind: str, kernel: str, names,
                   **shape_kw):
    """Percent of the least time the traced stretches' calls of ``kernel``
    could take (the frozen ``reference.cost`` at each call's shapes,
    ``shape_kw`` its fixed arguments, against ``reference.peaks``) over the
    device time of the kernels whose names hold one of ``names``, both
    summed over the ranks; None where no stretch has such a call or
    kernel."""
    from reference import cost, peaks
    sts = stretches(readings, kind)
    calls = [c for st in sts for c in st["calls"] if c["name"] == kernel]
    spent = sum(kernel_seconds(st, names) for st in sts)
    if not calls or spent <= 0:
        return None
    least = sum(peaks.bound_s(cost.kernel_cost(kernel, *c["shapes"],
                                               dtype=c["dtype"], **shape_kw),
                              c["route"]) for c in calls)
    return 100 * least / spent


def idle_share(readings: dict, kind: str):
    """Percent of the traced stretch in which no device operation ran, the
    mean over the ranks."""
    sts = stretches(readings, kind)
    if not sts:
        return None
    dev = device_seconds(sts)
    return 100 * (1 - dev["busy_s"] / dev["window_s"])


def breakdown(stretch: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the innermost host operation running at its
    middle (of one rank's stretch: rank 0's)."""
    w0, w1 = stretch["window_us"]
    by_name = {}
    for n, _, d in stretch["device"]:
        by_name[n[:160]] = by_name.get(n[:160], 0.0) + d / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged_busy(stretch["device"], w0, w1)
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        around = [(d, n) for n, s, d in stretch["host"] if s <= mid <= s + d]
        named.append([min(around)[1][:160] if around else "host idle",
                      length / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def read_metrics(entries, readings: dict) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics whose reader finds
    something to read in ``readings``."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"]).read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks(numbers: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}``, the limits' order."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def within(chk: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in chk.values())


def now() -> float:
    return time.perf_counter()
