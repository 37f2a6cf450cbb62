"""The port's examples run end to end on the host: the quickstart (Eq. 13
and a distributed MLP on 2 x 4 gloo ranks), the paper's §5 LeNet-5
experiment (2 x 2 gloo ranks, 10 steps), each asserting its own
equivalences and exiting non-zero when one fails, and the serving demo
(150 AdamW steps on the modular-drift task, then 4 streams x 16 greedy
tokens), which recovers the drift pattern exactly, as the reference's
``examples/serve_lm.py`` does on this host.  Without ``--device`` the
first two ask for the card, and raise here."""

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
    ("serve_lm_torch.py", ("--device", "cpu"), "pattern accuracy: 100.00%"),
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
