"""``chip_smoke.py``'s phase 21 (``uneven_widths``: widths the model axis
does not divide, split by the balanced decomposition) on its own, after
the device and build phases: (a) the flash and SSD kernels at the
per-rank shapes TP 3 gives glm4-9b and mamba2-370m on one card; (b) and
(c) where three cards or more exist, glm4-9b (40 layers) and mamba2-370m
(48 layers) served at (data, model) = (1, 3) under both layouts, and
mamba2-370m trained at (1, 3), on three NCCL ranks, each held to one
card and to the dry run.  One JSON line ``{"uneven_widths": ...}``,
also written to ``--out PATH`` when given (the ranks' results are long).

    python3 tools/uneven_widths_phase_torch.py [--out build/widths.json]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = cs.phase_device()
    cs.phase_build()
    cs.phase_uneven_widths(smi, args.out)


if __name__ == "__main__":
    main(sys.argv[1:])
