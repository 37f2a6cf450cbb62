"""The port's spans (``repro_torch.tracing.span``) on one NVIDIA card: what
a span costs with the profiler off and on, and one traced run of a
benchmark cell with every span path of its profiled stretch.

    python3 tools/spans_probe_torch.py --cost
    python3 tools/spans_probe_torch.py --workload <cell> --seed <n> \\
        --seconds <s> [--out <file>.json]

``--cost`` prints one JSON line: microseconds a span with the profiler off,
the bare ``record_function`` with it off, and a span while the profiler
records the CPU and the card.  A cell runs as ``bench/run.py --trace 1``
(its result line last on standard output) and writes to ``--out`` each
rank's span paths (``bench/spans.py``), the same paths with each launch
matched to its device operation by the trace's correlation ids (which the
stretch does not keep: ``spans.read`` pairs them by order) and the paths
and fields where the two differ, the threads each span name ran on, the
device's idle time by span path, the run's phases, and the Python garbage
collections of 1 ms or more (generation, milliseconds, whether inside the
profiled stretch).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"


def cost(n: int = 20000) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing

    def per_call(make):
        for _ in range(1000):
            with make("probe.x"):
                pass
        t = time.perf_counter()
        for _ in range(n):
            with make("probe.x"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"span_off_us": per_call(tracing.span),
           "record_function_off_us": per_call(record_function)}
    card = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU]
                 + [ProfilerActivity.CUDA] * card):
        out["span_on_us"] = per_call(tracing.span)
    out["device"] = torch.cuda.get_device_name(0) if card else "cpu"
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _complete(e, cats) -> bool:
    return e.get("ph") == "X" and "dur" in e and e.get("cat") in cats


def by_correlation(events, w0, w1) -> dict:
    """``spans.read``'s paths of the raw trace, each launch matched to its
    device operation by ``args.correlation``."""
    import spans

    sp = sorted(((float(e["ts"]), float(e["dur"]), e["name"])
                 for e in events if _complete(e, ("user_annotation",))
                 and e["name"].startswith(spans.PREFIXES)
                 and w0 <= float(e["ts"]) <= w1),
                key=lambda x: (x[0], -x[1]))
    rows = spans.read({"window_us": (w0, w1), "device": [],
                       "host": [(n, s, d) for s, d, n in sp]})
    path_of, active = {}, []
    for x in sp:
        active = [a for a in active if a[0] <= x[0] < a[0] + a[1]] + [x]
        path_of[x] = "/".join(a[2] for a in active)
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and _complete(e, LAUNCH_CATS):
            launch_ts[corr] = min(float(e["ts"]),
                                  launch_ts.get(corr, float("inf")))
    ops = [(launch_ts[c], float(e["dur"])) for e in events
           if _complete(e, DEVICE_CATS)
           and (c := (e.get("args") or {}).get("correlation")) in launch_ts
           and w0 <= launch_ts[c] <= w1]
    held = spans._innermost(sp, [t for t, _ in ops])
    for (_, dur), x in zip(ops, held):
        row = rows[path_of[x]] if x else rows[""]
        row["launches"] += 1
        row["device_us"] += dur
    return rows


def differences(got: dict, truth: dict) -> list:
    """``[path, field, got, truth]`` where the two readings differ by more
    than rounding."""
    out = []
    for path in sorted(set(got) | set(truth)):
        a, b = got.get(path, {}), truth.get(path, {})
        for k in ("count", "launches", "device_us"):
            x, y = a.get(k, 0), b.get(k, 0)
            if abs(x - y) > 1e-6 * max(abs(x), abs(y), 1):
                out.append([path, k, x, y])
    return out


def idle_by_span(events, w0, w1) -> dict:
    """The device's idle time in [w0, w1] (ms), split by the path of the
    program spans holding each idle moment (``""``: none), and the ten
    longest idle gaps with the path at their middle."""
    import harness
    import spans

    sp = sorted(((float(e["ts"]), float(e["dur"]), e["name"])
                 for e in events if _complete(e, ("user_annotation",))
                 and e["name"].startswith(spans.PREFIXES)),
                key=lambda x: (x[0], -x[1]))
    dev = [(None, float(e["ts"]), float(e["dur"])) for e in events
           if _complete(e, DEVICE_CATS)]
    busy = harness.merged_busy(dev, w0, w1)
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # cut each gap at every span edge inside it, name each piece by the
    # spans holding its middle (one sweep over the sorted middles)
    cuts = sorted({t for s in sp for t in (s[0], s[0] + s[1])})
    pieces = []
    for a, b in gaps:
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        pts = [a] + inner + [b]
        pieces += [((x + y) / 2, y - x) for x, y in zip(pts, pts[1:])]
    pieces.sort()
    by, active, i = collections.Counter(), [], 0
    for mid, length in pieces:
        while i < len(sp) and sp[i][0] <= mid:
            active.append(sp[i])
            i += 1
        active = [s for s in active if mid < s[0] + s[1]]
        by["/".join(s[2] for s in active)] += length / 1e3

    def path_at(t):
        return "/".join(s[2] for s in sp if s[0] <= t < s[0] + s[1])

    top = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"ms": dict(by.most_common()),
            "top": [[path_at((a + b) / 2), (b - a) / 1e3] for a, b in top]}


def cell(argv) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import harness
    import run
    import spans

    got = {"threads": [], "gc": [], "by_correlation": [],
           "differences": []}
    load_json, read_metrics = harness.load_json, harness.read_metrics
    profile_stretch = harness.profile_stretch
    clock = {"gc": 0.0, "stretch": []}
    raw = {}

    def collected(phase, info):
        t = time.perf_counter()
        if phase == "start":
            clock["gc"] = t
        elif t - clock["gc"] >= 1e-3:
            inside = any(a <= clock["gc"] and b is None
                         for a, b in clock["stretch"])
            got["gc"].append([info["generation"], 1e3 * (t - clock["gc"]),
                              inside])

    def loaded(path):
        out = load_json(path)
        if Path(path).name.startswith("stretch_trace."):
            raw["events"] = out["traceEvents"]
        return out

    def stretch(fn, *a, **kw):
        def timed():
            clock["stretch"].append([time.perf_counter(), None])
            fn()
            clock["stretch"][-1][1] = time.perf_counter()
        st = profile_stretch(timed, *a, **kw)
        events, (w0, w1) = raw.pop("events"), st["window_us"]
        got["threads"].append(sorted(collections.Counter(
            f"{e['name']}@{e.get('tid')}" for e in events
            if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(spans.PREFIXES)).items()))
        got.setdefault("idle_by_span", []).append(idle_by_span(events, w0,
                                                               w1))
        truth = by_correlation(events, w0, w1)
        got["by_correlation"].append(truth)
        got["differences"].append(differences(spans.read(st), truth))
        return st

    def metrics(entries, readings):
        got["spans"] = [spans.read(st) for st in readings["stretches"]]
        got["phases"] = readings.get("phases")
        return read_metrics(entries, readings)

    harness.load_json, harness.read_metrics = loaded, metrics
    harness.profile_stretch = stretch
    gc.callbacks.append(collected)
    code = run.main(["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(got, indent=1))
    sys.exit(code)


if __name__ == "__main__":
    if sys.argv[1:] == ["--cost"]:
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(cost()), flush=True)
    else:
        cell(sys.argv[1:])
