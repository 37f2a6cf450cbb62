"""``chip_smoke.py``'s phase 19 (``zero3``: the policy train program,
ZeRO-3 over data, tensor and sequence parallelism over model) on its own,
after the device and build phases: a short call on one NVIDIA card, (a)
at mesh (1, 1).  With ``--four-card-meshes`` it runs only (b): glm4-9b at
all 40 layers from the per-rank initialiser at (data, model) = (4, 1) and
(2, 2), the 2-layer fp32 parity at (2, 2), each mesh held to the dry
run's prediction, one NCCL rank per card; one JSON line
``{"zero3_mesh": ...}`` a mesh.

    python3 tools/zero3_phase_torch.py
    python3 tools/zero3_phase_torch.py --four-card-meshes
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
        cs.zero3_meshes(smi)
    elif not argv:
        print(json.dumps({"zero3_paths": cs.phase_zero3(smi)}), flush=True)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
