"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the port's
examples and its ``tools/*_torch.py`` import neither ``jax`` nor anything
of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT_EXAMPLES = [ROOT / "examples" / "quickstart_torch.py",
                 ROOT / "examples" / "lenet5_distributed_torch.py",
                 ROOT / "examples" / "train_lm_torch.py",
                 ROOT / "examples" / "serve_lm_torch.py"]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + PORT_EXAMPLES + sorted(
    (ROOT / "tools").glob("*_torch.py"))

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import lenet5_distributed_torch, quickstart_torch, serve_lm_torch, train_lm_torch
for name in ("repro_torch.sharding.policy", "repro_torch.core.compile",
             "repro_torch.core.overlap", "repro_torch.core.layers",
             "repro_torch.models.lenet", "repro_torch.core.pipeline",
             "repro_torch.launch.specs", "repro_torch.analysis",
             "repro_torch.analysis.spaces",
             "repro_torch.core.ring_attention",
             "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
             "repro_torch.resilience.inject",
             "repro_torch.analysis.hlo_lint", "repro_torch.launch.dryrun",
             "repro_torch.roofline.analysis",
             "repro_torch.roofline.hlo_profile",
             "repro_torch.roofline.report"):
    assert name in names, name
assert len(names) > 20, names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
assert "triton" not in sys.modules
print(len(names), "modules")
"""


def test_importing_every_module_loads_no_jax_or_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                           str(ROOT / "examples")]))
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.JoinedStr)):
            yield "".join(v.value for v in node.args[0].values
                          if isinstance(v, ast.Constant))


def test_no_source_names_jax_or_repro():
    assert len(PORT_FILES) > 20
    for path in PORT_FILES:
        for name in _imported(ast.parse(path.read_text())):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"
