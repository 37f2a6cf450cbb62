"""The per-layer readers and the trace's reduction, on readings made by
hand: busy time as the union of device intervals inside the stretch, the
idle gaps named by the innermost host operation, a roofline share as the
frozen bound over the kernels' device time, and nothing where a reader
finds nothing to read."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from reference import cost, peaks  # noqa: E402

GLM = json.loads((BENCH / "configs" / "glm4-9b.json").read_text())
Q, KV = (4, 2048, 32, 128), (4, 2048, 2, 128)
STRETCH = {
    "window_us": (1000.0, 2000.0),
    "device": [("void (anonymous namespace)::flash_tc_kernel<128>(...)",
                1100.0, 200.0),
               ("nvjet_gemm", 1250.0, 150.0),      # overlaps the first
               ("elementwise", 1800.0, 300.0)],    # runs past the end
    "host": [("aten::matmul", 1390.0, 500.0), ("aten::item", 1580.0, 50.0)],
    "calls": [{"name": "flash_attention", "route": "tensor_core",
               "shapes": [Q, KV, KV], "dtype": "torch.bfloat16"}]}
SERVE = {"kind": "serve", "chips": 1, "cfg": GLM,
         "traffic": {"batch": 4, "prompt": 2048, "new_tokens": 4},
         "window": {"requests": 3, "elapsed_s": 1.5,
                    "ttft_s": [0.25, 0.2, 0.3], "decode_s": [0.1, 0.2, 0.3],
                    "decode_steps": 9},
         "stretches": [STRETCH]}


def test_busy_is_the_union_inside_the_stretch():
    assert harness.busy_seconds(STRETCH) == pytest.approx(500e-6)
    assert harness.idle_share(SERVE, "serve") == pytest.approx(50.0)
    assert harness.idle_share(SERVE, "train") is None


def test_gaps_named_by_the_innermost_host_op():
    b = harness.breakdown(STRETCH)
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(400e-6)]
    assert b["idle_gaps"][1] == ["host idle", pytest.approx(100e-6)]
    assert b["device_ops"][0][0].startswith("elementwise")


def test_flash_roofline_share():
    bound = peaks.bound_s(cost.kernel_cost("flash_attention", Q, KV, KV,
                                           dtype=torch.bfloat16, causal=True))
    got = harness.metric_reader("flash_fwd_roofline.serve").read(SERVE)
    assert got == pytest.approx(100 * bound / 200e-6)
    assert harness.metric_reader("flash_fwd_roofline.train").read(SERVE) \
        is None
    assert harness.metric_reader("ssd_fwd_roofline.serve").read(SERVE) is None


def test_serve_readers():
    assert harness.metric_reader("decode_step_ms.serve").read(SERVE) == \
        pytest.approx(1e3 * 0.6 / 9)
    mfu = harness.metric_reader("prefill_mfu.serve").read(SERVE)
    assert 0 < mfu < 100


def test_train_readers_and_what_is_left_out():
    train = {"kind": "train", "chips": 1, "cfg": dict(GLM, num_layers=8),
             "traffic": {"batch": 4, "seq": 1024},
             "window": {"steps": 100, "elapsed_s": 50.0},
             "phases": {"forward": [40.0, 42.0], "backward": [200.0, 202.0],
                        "optimizer": [100.0, 104.0]}}
    entries = [{"name": n, "unit": "ms"} for n in
               ("forward_ms.train", "backward_ms.train", "update_ms.train",
                "idle_share.train", "mfu.train")]
    got = harness.read_metrics(entries, train)
    assert got["forward_ms.train"]["value"] == 41.0
    assert got["update_ms.train"]["value"] == 102.0
    assert "idle_share.train" not in got
    assert 0 < got["mfu.train"]["value"] < 100


def test_percentile_is_nearest_rank():
    assert harness.percentile(range(1, 101), 95) == 95
    assert harness.percentile([3.0, 1.0, 2.0], 95) == 3.0
