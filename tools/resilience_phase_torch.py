"""``chip_smoke.py``'s phase 14 (``resilience``) on its own, after the
device and build phases: a short call on one NVIDIA card.  With
``--four-card-meshes`` it runs only the phase's four-card part (c), one
NCCL rank per card at (dp, pp, cp, tp, ep) = (2, 1, 1, 2, 1): the heal of
an ``OSError`` one rank's save raises, then the elastic shrink to (1, 1,
1, 2, 1), and prints its results as one JSON line ``{"resilience4":
...}``.

    python3 tools/resilience_phase_torch.py
    python3 tools/resilience_phase_torch.py --four-card-meshes
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def main(argv):
    smi = cs.phase_device()
    cs.phase_build()
    if argv == ["--four-card-meshes"]:
        print(json.dumps({"resilience4": cs.resilience_meshes(smi)}),
              flush=True)
    elif not argv:
        cs.phase_resilience(smi)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
