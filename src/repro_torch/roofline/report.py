"""Render the dry run's JSON cache (``launch/dryrun.py``) into tables
(mirrors ``repro/roofline/report.py``).  Every number in them is a bound
from shapes over the H100 data sheet, a prediction, not a measurement.

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh 16x16] [--kind roofline|dryrun|refused]
"""

from __future__ import annotations

import argparse
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def load(mesh: str) -> list[dict]:
    d = os.path.join(RESULTS_DIR, mesh)
    if not os.path.isdir(d):
        return []
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _lowered(rows):
    return [r for r in rows if not r.get("refused")]


def roofline_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mem/dev GiB | t_comp | t_mem | t_coll | "
           "bottleneck | useful | MFU bound |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in _lowered(rows):
        roof = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['memory']['peak_per_device_GiB']:.2f} "
            f"| {fmt_s(roof['t_compute_s'])} | {fmt_s(roof['t_memory_s'])} "
            f"| {fmt_s(roof['t_collective_s'])} | {roof['bottleneck']} "
            f"| {roof['useful_flops_ratio']:.2f} "
            f"| {roof['mfu_bound']*100:.1f}% |")
    return hdr + "\n".join(lines)


def dryrun_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | trace | args GiB | temp GiB | "
           "collective counts |\n|---|---|---|---|---|---|---|\n")
    lines = []
    for r in _lowered(rows):
        c = r["collectives"]["counts"]
        cc = " ".join(f"{k}:{v}" for k, v in sorted(c.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['trace_s']:.0f}s | {r['memory']['argument_GiB']:.2f} "
            f"| {r['memory']['temp_GiB']:.2f} | {cc} |")
    return hdr + "\n".join(lines)


def refused_table(rows: list[dict]) -> str:
    """The cells the port's own checks refuse, with its message."""
    hdr = "| arch | shape | program | refused |\n|---|---|---|---|\n"
    lines = [f"| {r['arch']} | {r['shape']} | {r['program']} "
             f"| {r['refused']} |" for r in rows if r.get("refused")]
    return hdr + "\n".join(lines)


TABLES = {"roofline": roofline_table, "dryrun": dryrun_table,
          "refused": refused_table}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--kind", default="roofline", choices=sorted(TABLES))
    args = ap.parse_args(argv)
    rows = load(args.mesh)
    if not rows:
        print(f"(no results for mesh {args.mesh})")
        return
    print(TABLES[args.kind](rows))


if __name__ == "__main__":
    main()
