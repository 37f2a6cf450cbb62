"""The readings a cell's limits are set from, on the chip at the cell's own
size, in one process (training: one process a rank, then this one):

- the program's numbers on each of ``--seeds`` (the lower readings):
  training, the checked steps of a run's set-up against the float32
  reference; serving, ``check_requests`` requests of the cell's traffic
  after the run's warm-up, each against the reference;
- on each of ``--control-seeds``, the control's numbers (the upper
  readings): the reference computed with its matmuls in fp8, put in the
  program's place; for training also the faults: half of each batch left
  out (the reference over the rest) and, on a mesh of more than one rank,
  the exchange between chips left out (``faults.no_exchange``, planted in
  the program).

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --out chiprun_out/control.json

Prints one JSON line a seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def rank_readings(rank, mesh, *, cell, run, seeds, fault_seeds) -> dict:
    """One rank: the checked steps' readings of the sound program on each
    of ``seeds``, then of the program with the exchange left out on each of
    ``fault_seeds``."""
    import faults
    import harness
    from kinds import train
    run = harness.rank_run(run, rank)
    policy = train.join_world(run.device, cell.workload["mesh"], mesh is None)
    out = {}
    try:
        for key, todo in (("program", seeds), ("fault_no_exchange",
                                               fault_seeds)):
            if key != "program":
                faults.no_exchange()
            for seed in todo:
                t = time.perf_counter()
                trainer = train.Trainer(cell, dataclasses.replace(
                    run, seed=seed), policy)
                out.setdefault(seed, {})[key] = trainer.prog
                out[seed][key + "_s"] = time.perf_counter() - t
                trainer.release()
    finally:
        if mesh is None:
            train.leave_world()
    return out


def train_rows(cell, run, seeds, control_seeds):
    import harness
    from kinds import train
    from reference import check, model
    conf, tr = cell.config, cell.traffic
    faulted = control_seeds if harness.world_size(cell) > 1 else []
    prog = harness.on_ranks(rank_readings, cell, run,
                            seeds=seeds + control_seeds,
                            fault_seeds=faulted)[0]
    devices = harness.cell_devices(cell, run)
    for seed in seeds + control_seeds:
        t = time.perf_counter()
        ref = train.reference(conf, tr, seed, devices)
        row = {"seed": seed, "program_s": prog[seed]["program_s"],
               "program": check.train_numbers(prog[seed]["program"], ref)}
        if seed in control_seeds:
            row["control_fp8"] = check.train_numbers(
                train.reference(conf, tr, seed, devices, mm=model.mm8), ref)
            row["fault_half_batch"] = check.train_numbers(
                train.reference(conf, tr, seed, devices, half_batch=True),
                ref)
        if seed in faulted:
            row["fault_no_exchange"] = check.train_numbers(
                prog[seed]["fault_no_exchange"], ref)
        row["reference_s"] = time.perf_counter() - t
        yield row


def serve_readings(cell, run, control: bool) -> dict:
    import gc

    import torch

    import harness
    from kinds import serve
    from reference.inputs import make_weights
    conf, tr, dev = cell.config, cell.traffic, run.device
    weights = make_weights(conf, run.seed, dev)
    engine = serve.ServeEngine(harness.program_config(conf), weights,
                               max_seq=tr["prompt"] + tr["new_tokens"],
                               batch_size=tr["batch"])
    client = serve.Client(engine, tr, conf, run.seed, dev)
    for w in range(serve.WARMUP):
        client.request(-1 - w)
    done = [client.request(r) for r in range(tr["check_requests"])]
    del client, engine
    gc.collect()
    torch.cuda.empty_cache()
    gaps = [serve.reference_gap(conf, tr, weights, run.seed, r,
                                d["tokens"], dev, control=control)
            for r, d in enumerate(done)]
    out = {"program": {"served_gap": max(g["gap"] for g in gaps)}}
    if control:
        out["control_fp8"] = {"served_gap": max(g["control_gap"]
                                                for g in gaps)}
    return out


def serve_rows(cell, run, seeds, control_seeds):
    import torch
    for seed in seeds + control_seeds:
        t = time.perf_counter()
        row = {"seed": seed, **serve_readings(
            cell, dataclasses.replace(run, seed=seed),
            seed in control_seeds), "seconds": time.perf_counter() - t}
        torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch

    import harness
    cell = harness.find_cell(args.workload)
    run = harness.Run(seed=0, seconds=0, trace=False,
                      device=torch.device("cuda", 0), t0=time.perf_counter(),
                      tmp=Path(tempfile.gettempdir()))
    rows_of = train_rows if cell.traffic["kind"] == "train" else serve_rows
    rows = []
    try:
        for row in rows_of(cell, run, args.seeds, args.control_seeds):
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(
                {"workload": args.workload,
                 "device": torch.cuda.get_device_name(0), "rows": rows},
                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
