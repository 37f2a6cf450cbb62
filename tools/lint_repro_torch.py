"""Repo-invariant AST lint over the PyTorch port (``src/repro_torch``).

One rule, the one that keeps the port's collective inventory complete:

  T1 raw-dist-collective    no raw ``torch.distributed`` collective or
                            point-to-point call outside
                            ``core/primitives.py`` and ``launch/mesh.py``.
                            Every other module communicates through the
                            primitives, which record each collective in
                            the active shape trace
                            (``roofline/hlo_profile.py``); a raw call
                            would be invisible to the dry run's
                            collective term and to ``analysis/hlo_lint``.

A line containing ``# repro-lint: allow`` is exempt.

  python tools/lint_repro_torch.py [--json] [--self-test]

``--self-test`` injects one violation in each spelling the rule knows
(``dist.``, ``torch.distributed.``, a name imported from
``torch.distributed``) and asserts each is caught.
"""

from __future__ import annotations

import argparse
import ast
import json
import pathlib
from dataclasses import asdict, dataclass

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "src/repro_torch"
ALLOWED = {"src/repro_torch/core/primitives.py",
           "src/repro_torch/launch/mesh.py"}
PRAGMA = "# repro-lint: allow"

COLLECTIVES = {
    "all_reduce", "all_reduce_coalesced", "all_gather",
    "all_gather_into_tensor", "all_gather_single", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp", "barrier", "monitored_barrier",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    lineno: int
    message: str


def _dist_aliases(tree) -> tuple[set, set, set]:
    """(names bound to ``torch.distributed``, names bound to ``torch``,
    collective names imported from ``torch.distributed``)."""
    mods, torches, names = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    mods.add(a.asname)
                elif a.name in ("torch", "torch.distributed"):
                    torches.add(a.asname or "torch")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "torch":
                mods.update(a.asname or a.name for a in node.names
                            if a.name == "distributed")
            elif node.module == "torch.distributed":
                names.update(a.asname or a.name for a in node.names
                             if a.name in COLLECTIVES)
    return mods, torches, names


def _is_dist(node, mods, torches) -> bool:
    """``node`` names the ``torch.distributed`` module."""
    if isinstance(node, ast.Name):
        return node.id in mods
    return (isinstance(node, ast.Attribute) and node.attr == "distributed"
            and isinstance(node.value, ast.Name)
            and node.value.id in torches)


def lint_source(text: str, path: str) -> list:
    """Findings of the rule over one file's source."""
    if path in ALLOWED:
        return []
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0, str(e))]
    lines = text.splitlines()
    mods, torches, names = _dist_aliases(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = ((isinstance(f, ast.Attribute) and f.attr in COLLECTIVES
                and _is_dist(f.value, mods, torches))
               or (isinstance(f, ast.Name) and f.id in names))
        if hit and PRAGMA not in lines[node.lineno - 1]:
            what = f.attr if isinstance(f, ast.Attribute) else f.id
            out.append(Finding(
                "raw-dist-collective", path, node.lineno,
                f"raw torch.distributed.{what} outside core/primitives.py "
                f"and launch/mesh.py: go through the primitives, which "
                f"record it in the collective inventory"))
    return out


def lint_repo(root: pathlib.Path = ROOT) -> list:
    out = []
    for p in sorted((root / PORT).rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        out += lint_source(p.read_text(), rel)
    return out


SELF_TEST = {
    "dist": "import torch.distributed as dist\ndist.all_reduce(x)\n",
    "torch.distributed": "import torch\ntorch.distributed.barrier()\n",
    "from-import": "from torch.distributed import isend\nisend(x, 1)\n",
    "from-torch": "from torch import distributed as d\n"
                  "d.all_to_all_single(a, b)\n",
}


def self_test() -> int:
    bad = [k for k, src in SELF_TEST.items()
           if not lint_source(src, f"{PORT}/injected.py")]
    if bad:
        print(f"self-test FAILED: not caught: {bad}")
        return 1
    print(f"self-test: {len(SELF_TEST)} injected violations caught")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    findings = lint_repo()
    if args.json:
        print(json.dumps([asdict(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f"{f.path}:{f.lineno}: {f.rule}: {f.message}")
        print(f"lint_repro_torch: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
