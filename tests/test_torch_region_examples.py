"""The port's two examples run end to end on the host: the quickstart
(Eq. 13 and a distributed MLP on 2 x 4 gloo ranks) and the paper's §5
LeNet-5 experiment (2 x 2 gloo ranks, 10 steps).  Each asserts its own
equivalences and exits non-zero when one fails.  Without ``--device`` both
ask for the card, and raise here."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, str(EXAMPLES / name), *args],
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("name,args,says", [
    ("quickstart_torch.py", ("--device", "cpu"),
     "distributed == sequential ✓"),
    ("lenet5_distributed_torch.py", ("--device", "cpu", "--steps", "10"),
     "distributed ≡ sequential ✓"),
])
def test_example_runs_on_host(name, args, says):
    proc = _run(name, *args)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert says in proc.stdout


@pytest.mark.parametrize("name", ["quickstart_torch.py",
                                  "lenet5_distributed_torch.py"])
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    proc = _run(name, "--mesh", "1,1")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
