"""``chip_smoke.py``'s phases 8 and 17 (bf16 training of glm4-9b cut to 8
layers and of mamba2-370m at all 48 layers) and 18 (the dry run held
against the card) on their own, after the device and build phases: a
short call on one NVIDIA card.  Before them it runs the host-only
commands of the dry run on the card machine's torch: one 16 x 16 cell
(``repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k``, the
fake world) and ``repro_torch.analysis.hlo_lint --quickstart`` (8 gloo
ranks).  It prints one JSON line ``{"dryrun_phase": ...}``.

    python3 tools/dryrun_phase_torch.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def host_command(*args, timeout=600):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    return {"cmd": " ".join(args), "rc": proc.returncode,
            "tail": (proc.stdout + proc.stderr)[-1500:]}


def main():
    smi = cs.phase_device()
    host = [host_command("repro_torch.launch.dryrun", "--arch", "glm4-9b",
                         "--shape", "decode_32k"),
            host_command("repro_torch.analysis.hlo_lint", "--quickstart")]
    cs.phase_build()
    cells, snaps = {}, {}
    for arch in (cs.GLM, cs.MAMBA):
        snaps[arch], cells[f"train {arch}"] = cs.phase_train(smi, arch)
    res = cs.phase_dryrun(smi, cells)
    print(json.dumps({"dryrun_phase": {"host": host, "launches": snaps,
                                       "cells": res}}), flush=True)
    if any(h["rc"] for h in host):
        raise SystemExit("a host command failed")


if __name__ == "__main__":
    main()
