"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``;
its files are found by name (``harness.py``).  With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison judged beside its limit); the last lines of standard error are
the same numbers.

The kernels' build and cache directories are fixed paths inside the
checkout (``build/``).  The run exits with a code other than 0, and prints
no result, without the port's sources, without as many CUDA cards as the
cell asks for, or when the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(code: int, why: str):
    print(f"bench: {why}", file=sys.stderr, flush=True)
    sys.exit(code)


def loaded_forbidden() -> list:
    """The forbidden packages among the loaded modules, by whole top-level
    name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv")
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, f"the port's sources are not in {ROOT / 'src'}")
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    import harness
    man = harness.manifest()
    cell = harness.find_cell(args.workload, man)

    import torch
    if not torch.cuda.is_available():
        fail(3, "no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"{args.workload} needs {cell.chips} CUDA cards, "
                f"{torch.cuda.device_count()} present")
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        run = harness.Run(seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace),
                          device=torch.device("cuda", 0), t0=T0, tmp=tmp)
        out = harness.kind_module(cell.traffic["kind"]).run(cell, run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = loaded_forbidden()
    if found:
        fail(4, f"loaded {', '.join(found)}: the benchmark runs the port "
                "alone")

    entries = harness.cell_metrics(args.workload, bool(args.trace), man)
    if args.trace:
        metrics = harness.read_metrics(entries, out["readings"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in entries}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit_w": power_limit_w()}
    if args.trace:
        device.update(out["device_extra"])
    result = {"correct": harness.within(out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(f"bench: notes {json.dumps(out.get('notes', {}))}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
