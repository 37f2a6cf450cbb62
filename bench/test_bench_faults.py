"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run of a cell's kind on the host (the look
for a card skipped), at a reduced size in float32, against the cell's own
limits: a sound run is correct; a train step that returns its state
unchanged, or that leaves half of the batch out and takes the mean over
the rest, is not; nor is a four-rank step with the exchange between ranks
left out (four gloo processes, the cell's own (data, model) mesh); nor is
a served token altered where it is picked; nor is the control, the
reference computed with its matmuls in fp8 and put in the program's
place."""

from __future__ import annotations

import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]

import faults  # noqa: E402
import harness  # noqa: E402
from kinds import serve, train  # noqa: E402
from reference import check, model  # noqa: E402

DENSE = {"program": "glm4-9b", "num_layers": 2, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 96,
         "vocab_size": 256, "mlp_type": "swiglu", "rope_theta": 10000.0,
         "tie_embeddings": False, "dtype": "float32"}
SSM = {"program": "mamba2-370m", "num_layers": 2, "d_model": 64,
       "num_heads": 0, "num_kv_heads": 0, "head_dim": 0, "d_ff": 0,
       "vocab_size": 256, "ssm_state": 16, "ssm_expand": 2,
       "ssm_head_dim": 16, "conv_kernel": 4, "tie_embeddings": True,
       "dtype": "float32"}
SEED = 2**31 + 17


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads, as the other test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small_cell(name: str, conf: dict, **traffic) -> harness.Cell:
    """Cell ``name`` of the manifest, its configuration and traffic cut to
    a host's size; its kind, chips, mesh and limits as they stand."""
    cell = harness.find_cell(name)
    return harness.Cell(name, cell.chips, conf, dict(cell.traffic, **traffic),
                        cell.workload)


def mesh_cell(name: str, conf: dict, traffic: str, **cut) -> harness.Cell:
    """Cell ``name`` from its own files, not yet in the manifest (its
    workload file gives the mesh and limits), cut like ``small_cell``."""
    work = harness.load_json(BENCH / "workloads" / f"{name}.json")
    tr = harness.load_json(BENCH / "traffic" / f"{traffic}.json")
    return harness.Cell(name, math.prod(work["mesh"]), conf,
                        dict(tr, **cut), work)


def small_run(faults=None) -> harness.Run:
    return harness.Run(seed=SEED, seconds=0.3, trace=False,
                       device=torch.device("cpu"), t0=time.perf_counter(),
                       tmp=Path(tempfile.gettempdir()), faults=faults or {})


TRAIN = ("train.glm4-9b.l8", DENSE, {"seq": 64})
MESH = ("train.glm4-9b.zero3-2x2", DENSE, "train-b8-s1024", {"seq": 64})
SERVES = {"dense": ("serve.glm4-9b.p2048-o4", DENSE,
                    {"prompt": 40, "check_requests": 2}),
          "ssm": ("serve.mamba2-370m.p8192-o4", SSM,
                  {"prompt": 40, "check_requests": 2})}


def test_sound_train_run_is_correct():
    name, conf, tr = TRAIN
    out = train.run(small_cell(name, conf, **tr), small_run())
    assert harness.within(out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_broken_train_step_is_not_correct(fault):
    name, conf, tr = TRAIN
    out = train.run(small_cell(name, conf, **tr), small_run({"step": fault}))
    assert not harness.within(out["checks"]), out["checks"]


def test_sound_four_rank_train_run_is_correct():
    name, conf, traffic, tr = MESH
    cell = mesh_cell(name, conf, traffic, **tr)
    assert harness.world_size(cell) == 4
    out = train.run(cell, small_run())
    assert harness.within(out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_four_ranks_without_their_exchange_are_not_correct():
    name, conf, traffic, tr = MESH
    out = train.run(mesh_cell(name, conf, traffic, **tr),
                    small_run({"rank": faults.no_exchange}))
    assert not harness.within(out["checks"]), out["checks"]


@pytest.mark.parametrize("kind", SERVES)
def test_sound_serve_run_is_correct(kind):
    name, conf, tr = SERVES[kind]
    out = serve.run(small_cell(name, conf, **tr), small_run())
    assert harness.within(out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("kind", SERVES)
def test_altered_token_is_not_correct(kind):
    name, conf, tr = SERVES[kind]
    out = serve.run(small_cell(name, conf, **tr),
                    small_run({"engine": faults.altered_token}))
    assert not harness.within(out["checks"]), out["checks"]


def test_train_control_is_not_correct():
    name, conf, tr = TRAIN
    cell = small_cell(name, conf, **tr)
    try:
        cpu = [torch.device("cpu")]
        ref = train.reference(conf, cell.traffic, SEED, cpu)
        low = train.reference(conf, cell.traffic, SEED, cpu, mm=model.mm8)
    finally:
        train.leave_world()
    chk = harness.checks(check.train_numbers(low, ref), cell.limits)
    assert not harness.within(chk), chk


def _control_gaps(name, conf, requests, **traffic):
    from reference.inputs import make_weights
    cell = small_cell(name, conf, **traffic)
    w = make_weights(conf, SEED, "cpu")
    served = np.zeros((cell.traffic["batch"], cell.traffic["new_tokens"]),
                      dtype=np.int64)
    return cell, [serve.reference_gap(conf, cell.traffic, w, SEED, r, served,
                                      torch.device("cpu"), control=True)
                  ["control_gap"] for r in range(requests)]


def test_dense_serve_control_is_not_correct():
    name, conf, tr = SERVES["dense"]
    cell, gaps = _control_gaps(name, conf, 4, **tr)
    chk = harness.checks({"served_gap": max(gaps)}, cell.limits)
    assert not harness.within(chk), chk


def test_ssm_serve_control_is_not_correct():
    """mamba2-370m as the cell runs it, all 48 layers and its
    initialisation, on two prompts of 32 tokens; d_model 256 with the
    embedding's std doubled, so the logits keep the cell's scale
    (sqrt(d_model) x std = 0.64): the control's gap grows with depth, so a
    cut in depth would not reach the cell's limit."""
    name = SERVES["ssm"][0]
    real = harness.find_cell(name).config
    conf = dict(real, d_model=256,
                init=dict(real["init"], embed_std=2 * real["init"]
                          ["embed_std"]))
    cell, gaps = _control_gaps(name, conf, 2, prompt=32, batch=2)
    chk = harness.checks({"served_gap": max(gaps)}, cell.limits)
    assert not harness.within(chk), chk
