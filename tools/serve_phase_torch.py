"""``chip_smoke.py``'s phases 15 (``frontends``) and 16 (``serve_sharded``)
on their own, after the device and build phases: a short call on one
NVIDIA card; ``--serve-sharded`` runs phase 16 alone.  With
``--four-card-meshes`` it runs only sharded serving on the mesh that
needs four cards, (data, model) = (1, 4), one NCCL rank per card, the
cells of ``chip_smoke.SERVE_MESH_CELLS`` named after it (all of them
without a name): ``mistral`` (mistral-large-123b) and ``jamba``
(jamba-v0.1-52b) at full width cut to their parity depth against the
one-card engine (fp32 and bf16, both cache layouts), then at full depth
from the per-rank initialiser (prefill and decode tok/s, peak memory and
launches per rank); ``glm4`` (glm4-9b, 2 K/V heads) at full depth
against the one-card engine.  It prints one JSON line ``{"serve4":
...}`` of rank 0's results without the token lists, and with ``--out
PATH`` (after the cells) writes every rank's whole to PATH.

    python3 tools/serve_phase_torch.py
    python3 tools/serve_phase_torch.py --serve-sharded
    python3 tools/serve_phase_torch.py --four-card-meshes [jamba glm4 ...] \
        [--out results.json]
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)


def _without_tokens(tree):
    if isinstance(tree, dict):
        return {k: _without_tokens(v) for k, v in tree.items()
                if k not in ("tokens", "host_top")}
    if isinstance(tree, list):
        return [_without_tokens(v) for v in tree]
    return tree


def main(argv):
    four = argv[:1] == ["--four-card-meshes"]
    out = None
    if four and len(argv) > 2 and argv[-2] == "--out":
        argv, out = argv[:-2], Path(argv[-1])
    cells = (argv[1:] or tuple(cs.SERVE_MESH_CELLS)) if four else ()
    if (not set(cells) <= set(cs.SERVE_MESH_CELLS)
            or not four and argv not in ([], ["--serve-sharded"])):
        raise SystemExit(__doc__)
    smi = cs.phase_device()
    cs.phase_build()
    if four:
        res = cs.serve_meshes(smi, cells)
        if out is not None:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(res))
        print(json.dumps({"serve4": _without_tokens(
            {**res, "ranks": res.get("ranks", [None])[:1]})}), flush=True)
        return
    if not argv:
        cs.phase_frontends(smi)
    cs.phase_serve_sharded(smi)


if __name__ == "__main__":
    main(sys.argv[1:])
