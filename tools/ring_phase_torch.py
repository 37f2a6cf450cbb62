"""``chip_smoke.py``'s phase 13 (``ring``) on its own, after the device and
build phases and the flash kernels' checks at every head dim (112
included): a short call on one NVIDIA card.  With ``--four-card-meshes``
it runs only the phase's hybrid step with a live ctx axis on the meshes
that need four cards, (dp, pp, cp, tp, ep) = (1, 1, 4, 1, 1) and
(1, 1, 2, 2, 1), one NCCL rank per card, and prints their results as one
JSON line ``{"ring4": ...}``.

    python3 tools/ring_phase_torch.py
    python3 tools/ring_phase_torch.py --four-card-meshes
"""
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def main(argv):
    smi = cs.phase_device()
    cs.phase_build()
    if argv == ["--four-card-meshes"]:
        print(json.dumps({"ring4": cs.ring_meshes(smi)}), flush=True)
    elif not argv:
        gen = torch.Generator(device="cuda").manual_seed(0)
        cs.phase_tensor_core_checks(gen)
        cs.phase_head_dim_112(gen)
        cs.phase_ring(smi)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
