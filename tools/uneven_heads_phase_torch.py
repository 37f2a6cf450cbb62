"""``chip_smoke.py``'s phase 20 (``uneven_heads``: query heads the model
axis does not divide, split by the balanced decomposition) on its own,
after the device and build phases: (a) the flash kernel at every 16-way
rank shape of llama4-maverick-400b-a17b, phi3-medium-14b, phi4-mini-3.8b
and musicgen-medium on one card; (b) where three cards or more exist,
phi3-medium-14b at (data, model) = (1, 3) on three NCCL ranks, held to
one card's step and to the dry run.  One JSON line
``{"uneven_heads": ...}``.

    python3 tools/uneven_heads_phase_torch.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def main(argv):
    if argv:
        raise SystemExit(__doc__)
    smi = cs.phase_device()
    cs.phase_build()
    cs.phase_uneven_heads(smi)


if __name__ == "__main__":
    main(sys.argv[1:])
