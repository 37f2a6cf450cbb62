"""``tools/lint_repro_torch.py``: no raw ``torch.distributed`` collective
outside ``core/primitives.py`` and ``launch/mesh.py``, the rule that
keeps the port's collective inventory (``roofline/hlo_profile.py``)
complete.  Covers: the tree is clean; each spelling of a raw call is
caught; the two home files and the pragma are exempt; a process-group
query is not a collective."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "lint_repro_torch", ROOT / "tools" / "lint_repro_torch.py")
lint = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = lint
_spec.loader.exec_module(lint)

PATH = "src/repro_torch/models/injected.py"


def test_repo_is_clean():
    assert lint.lint_repo() == []
    assert lint.main([]) == 0


def test_self_test_passes():
    assert lint.self_test() == 0


@pytest.mark.parametrize("src", sorted(lint.SELF_TEST.values()))
def test_each_spelling_of_a_raw_call_is_caught(src):
    (f,) = lint.lint_source(src, PATH)
    assert (f.rule, f.lineno) == ("raw-dist-collective", 2)


@pytest.mark.parametrize("path", sorted(lint.ALLOWED))
def test_home_files_are_exempt(path):
    assert lint.lint_source(lint.SELF_TEST["dist"], path) == []


def test_pragma_and_queries_are_not_findings():
    src = ("import torch.distributed as dist\n"
           "dist.barrier()  # repro-lint: allow\n"
           "r = dist.get_rank(); n = dist.get_world_size()\n"
           "g = dist.get_process_group_ranks(group)\n")
    assert lint.lint_source(src, PATH) == []
    assert lint.lint_source("def f(:\n", PATH)[0].rule == "syntax-error"
