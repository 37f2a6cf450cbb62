"""The program's spans in a profiled stretch, and the device work launched
under each, read from the stretch's host and device operations
(``harness.profile_stretch``: each ``(name, start_us, dur_us)``).

A program span is a host operation whose name starts with one of
``PREFIXES`` (``repro_torch.tracing.span``); the profiler's operator
events and the CUDA calls are not.  A span's path is the names of the
program spans whose intervals hold its start, on any thread, outermost
first, joined by ``/``: the autograd engine's thread runs a kernel's
backward while the main thread waits.

A launch is a CUDA call that queues a device operation: a kernel
(``cudaLaunch*``, ``cuLaunch*``), a copy (``*Memcpy*``) or a set
(``*Memset*``), but not a host function queued on the stream; a call
that runs inside another launch's interval (the driver under the runtime)
is the same launch.  The stretch keeps no
correlation of a launch with its operation, so the two are paired by
order, kind by kind: the n-th kernel launched is the n-th kernel to start
on the device, which holds on one stream.  A launch counts under the
innermost program span holding its start, on any thread, or under the
path ``""`` where none holds it, and its operation's device time with it.
"""

from __future__ import annotations

PREFIXES = ("optim.", "kernels.", "serve.", "model.")
LAUNCH_KINDS = (("Memcpy", ("cudaMemcpy", "cuMemcpy")),
                ("Memset", ("cudaMemset", "cuMemset")),
                ("kernel", ("cudaLaunch", "cuLaunch")))
NOT_LAUNCHES = ("cudaLaunchHostFunc", "cuLaunchHostFunc")


def _launch_kind(name: str):
    if name.startswith(NOT_LAUNCHES):
        return None
    return next((k for k, calls in LAUNCH_KINDS if name.startswith(calls)),
                None)


def _device_kind(name: str) -> str:
    return next((k for k, _ in LAUNCH_KINDS[:2] if name.startswith(k)),
                "kernel")


def _holds(s, t) -> bool:
    return s[0] <= t < s[0] + s[1]


def _innermost(spans, times) -> list:
    """For each of ``times``, the innermost of ``spans`` (``(start, dur,
    name)``, sorted by start, the longer of two first) whose interval
    holds it, or None."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [None] * len(times)
    active, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if _holds(s, t)]
        out[k] = active[-1] if active else None
    return out


def _launches(host, w0: float, w1: float) -> dict:
    """``{kind: [start, ...]}`` of the stretch's launches, in order."""
    calls = sorted((s, d, k) for n, s, d in host
                   if w0 <= s <= w1 and (k := _launch_kind(n)))
    out, end = {k: [] for k, _ in LAUNCH_KINDS}, float("-inf")
    for s, d, k in calls:
        if s + d <= end:        # inside the launch before it
            continue
        out[k].append(s)
        end = s + d
    return out


def _row():
    return {"count": 0, "host_us": 0.0, "device_us": 0.0, "launches": 0}


def read(stretch: dict) -> dict:
    """``{path: {"count", "host_us", "device_us", "launches"}}`` of the
    stretch: each path's spans, their host time, the device time of the
    operations launched under them and the number of those operations."""
    w0, w1 = stretch["window_us"]
    spans = sorted(((s, d, n) for n, s, d in stretch["host"]
                    if n.startswith(PREFIXES) and w0 <= s <= w1),
                   key=lambda s: (s[0], -s[1]))
    out = {"": _row()}
    path_of, active = {}, []
    for s in spans:     # those holding s's start come before it
        active = [a for a in active if _holds(a, s[0])] + [s]
        path_of[s] = "/".join(a[2] for a in active)
        row = out.setdefault(path_of[s], _row())
        row["count"] += 1
        row["host_us"] += s[1]

    ops = {k: [] for k, _ in LAUNCH_KINDS}
    for n, s, d in sorted(stretch["device"], key=lambda o: o[1]):
        if s >= w0:
            ops[_device_kind(n)].append(d)
    launched = _launches(stretch["host"], w0, w1)
    pairs = [(t, d) for k, starts in launched.items()
             for t, d in zip(starts, ops[k])]
    held = _innermost(spans, [t for t, _ in pairs])
    for (_, dur), span in zip(pairs, held):
        row = out[path_of[span]] if span else out[""]
        row["launches"] += 1
        row["device_us"] += dur
    return out


def under(spans: dict, name: str, within: str | None = None):
    """The work under the span ``name``: ``{"count", "host_us",
    "device_us", "launches"}`` summed over the paths that hold it (and,
    with ``within``, start with that span), ``count`` and ``host_us`` of
    the spans ``name`` itself; None where no path holds it."""
    rows = [(p.split("/"), r) for p, r in spans.items()]
    rows = [(p, r) for p, r in rows if name in p
            and (within is None or p[0] == within)]
    if not rows:
        return None
    own = [r for p, r in rows if p[-1] == name]
    return {"count": sum(r["count"] for r in own),
            "host_us": sum(r["host_us"] for r in own),
            "device_us": sum(r["device_us"] for _, r in rows),
            "launches": sum(r["launches"] for _, r in rows)}


def mean_per(readings: dict, kind: str, name: str, field: str, units,
             within: str | None = None):
    """``field`` of the work under span ``name`` (``under``) over
    ``units(stretch)``, the mean over the ranks' stretches; None for
    another kind, an untraced run, or a stretch without span ``name``
    (a program without spans)."""
    if readings.get("kind") != kind or not readings.get("stretches"):
        return None
    vals = []
    for st in readings["stretches"]:
        got = under(read(st), name, within)
        if got is None:
            return None
        vals.append(got[field] / units(st))
    return sum(vals) / len(vals)
