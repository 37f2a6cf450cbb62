"""``chip_smoke.py``'s phases 15 (``frontends``) and 16 (``serve_sharded``)
on their own, after the device and build phases: a short call on one
NVIDIA card.  With ``--four-card-meshes`` it runs only sharded serving on
the mesh that needs four cards, (data, model) = (1, 4), one NCCL rank per
card: mistral-large-123b at full width cut to 2 layers against the
one-card engine (fp32 and bf16, both cache layouts), then at full depth
from the per-rank initialiser (prefill and decode tok/s, peak memory and
launches per rank), printed as one JSON line ``{"serve4": ...}``.

    python3 tools/serve_phase_torch.py
    python3 tools/serve_phase_torch.py --four-card-meshes
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
        print(json.dumps({"serve4": cs.serve_meshes(smi)}), flush=True)
    elif not argv:
        cs.phase_frontends(smi)
        cs.phase_serve_sharded(smi)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
