"""``chip_smoke.py``'s phase 12 (``moe``) on its own, after the device and
build phases: a short call on one NVIDIA card.  With ``--four-card-meshes``
it runs only the phase's hybrid MoE step on the meshes that need four
cards, (dp, pp, cp, tp, ep) = (1, 1, 1, 1, 4) (which also times the MoE
sub-layer at ep 4) and (1, 1, 1, 2, 2), one NCCL rank per card, and prints
each rank's result as one JSON line ``{"moe4": ...}``.

    python3 tools/moe_phase_torch.py
    python3 tools/moe_phase_torch.py --four-card-meshes
"""
import functools
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def four_card_meshes(smi):
    out = {}
    for name in ("ep4", "ep2_tp2"):
        mesh = cs.MOE_MESHES[name]
        ranks = cs.launch_mesh.spawn(
            functools.partial(cs.moe_hybrid_rank, mesh=mesh),
            math.prod(mesh), device="cuda", timeout_s=600)
        if len({r["loss"] for r in ranks}) != 1:
            raise AssertionError(f"moe hybrid {mesh}: ranks disagree")
        out[name] = ranks
    print(json.dumps({"moe4": out, "nvidia_smi": smi}), flush=True)


def main(argv):
    smi = cs.phase_device()
    cs.phase_build()
    if argv == ["--four-card-meshes"]:
        four_card_meshes(smi)
    elif not argv:
        cs.phase_moe(smi)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
