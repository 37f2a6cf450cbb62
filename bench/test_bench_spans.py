"""The program's spans read from a profiled stretch (``spans.read``), on
chrome-trace events made by hand and split as ``harness.profile_stretch``
splits them, and the five readers over them: each span's path by the
spans holding its start on any thread, each launch paired by order with
its device operation, kind by kind, and counted under the innermost span
holding it, and nothing where a reader finds no span."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import spans  # noqa: E402


def X(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def stretch(events, w0=None, w1=None) -> dict:
    """The stretch ``harness.profile_stretch`` makes of ``events``: its
    window is ``bench.stretch``'s (or [w0, w1])."""
    span = next(e for e in events if e["name"] == harness.SPAN)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e["name"], float(e["ts"]), float(e["dur"]))
        if e["cat"] in harness.DEVICE_CATS:
            device.append(item)
        elif e["cat"] in harness.HOST_CATS and e["name"] != harness.SPAN:
            host.append(item)
    return {"window_us": (span["ts"] if w0 is None else w0,
                          span["ts"] + span["dur"] if w1 is None else w1),
            "device": device, "host": host, "calls": []}


EVENTS = [
    X("user_annotation", "bench.stretch", 0, 1000),
    X("user_annotation", "serve.prefill", 100, 400),
    X("user_annotation", "model.attn", 150, 100),
    X("cpu_op", "aten::mm", 155, 20),
    X("user_annotation", "serve.decode_step", 550, 200),
    # the autograd engine's thread, inside the main thread's span
    X("user_annotation", "kernels.flash_attention.bwd", 600, 50, tid=2),
    X("gpu_user_annotation", "serve.prefill", 120, 300, tid=7),
    # a kernel launched through the runtime and the driver: one launch
    X("cuda_runtime", "cudaLaunchKernel", 160, 5),
    X("cuda_driver", "cuLaunchKernel", 161, 3),
    X("kernel", "nvjet_gemm", 170, 30, tid=7),
    X("cuda_runtime", "cudaMemcpyAsync", 300, 5),
    # a set launched on a third thread while the main thread's span holds
    X("cuda_runtime", "cudaMemsetAsync", 560, 2, tid=3),
    X("cuda_driver", "cuLaunchKernelEx", 610, 4, tid=2),
    X("cuda_runtime", "cudaLaunchHostFunc", 620, 2, tid=2),
    # outside every program span
    X("cuda_runtime", "cudaLaunchKernel", 800, 4),
    # a sync, which queues nothing
    X("cuda_runtime", "cudaStreamSynchronize", 900, 50),
    # the device's operations, listed out of order: each kind in turn
    X("kernel", "reduce", 810, 7, tid=7),
    X("gpu_memset", "Memset (Device)", 565, 5, tid=7),
    X("kernel", "elementwise", 620, 40, tid=7),
    X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 310, 10, tid=7),
]


def row(count, host_us, device_us, launches):
    return {"count": count, "host_us": host_us, "device_us": device_us,
            "launches": launches}


def test_paths_and_launches():
    assert spans.read(stretch(EVENTS)) == {
        "": row(0, 0.0, 7.0, 1),
        "serve.prefill": row(1, 400.0, 10.0, 1),
        "serve.prefill/model.attn": row(1, 100.0, 30.0, 1),
        "serve.decode_step": row(1, 200.0, 5.0, 1),
        "serve.decode_step/kernels.flash_attention.bwd": row(1, 50.0, 40.0,
                                                             1)}


def test_launches_outside_the_stretch_are_left_out():
    got = spans.read(stretch(EVENTS, 140.0, 700.0))
    assert "serve.prefill" not in got
    assert got["model.attn"] == row(1, 100.0, 30.0, 1)
    assert got[""] == row(0, 0.0, 10.0, 1)     # the copy, now in no span


def test_kinds_pair_in_order():
    # two kernels and a copy, the copy launched between them: each kind
    # pairs its launches with its own operations, in order
    events = [X("user_annotation", "bench.stretch", 0, 100),
              X("user_annotation", "model.ffn", 0, 10),
              X("user_annotation", "model.attn", 20, 10),
              X("user_annotation", "model.ssm", 40, 10),
              X("cuda_runtime", "cudaLaunchKernel", 1, 1),
              X("cuda_runtime", "cudaMemcpyAsync", 21, 1),
              X("cuda_driver", "cuLaunchKernel", 41, 1),
              X("kernel", "b", 70, 3),
              X("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60, 2),
              X("kernel", "a", 50, 5)]
    got = spans.read(stretch(events))
    assert got["model.ffn"] == row(1, 10.0, 5.0, 1)
    assert got["model.attn"] == row(1, 10.0, 2.0, 1)
    assert got["model.ssm"] == row(1, 10.0, 3.0, 1)


def test_nested_spans_of_one_name_and_ties():
    events = [X("user_annotation", "bench.stretch", 0, 100),
              X("user_annotation", "serve.prefill", 0, 100),
              X("user_annotation", "model.ssm", 0, 50),
              X("user_annotation", "kernels.ssd_scan.bwd", 10, 10),
              X("cuda_runtime", "cudaLaunchKernel", 0, 1),
              X("kernel", "k", 5, 2),
              X("cuda_runtime", "cudaLaunchKernel", 15, 1),
              X("kernel", "k", 20, 3)]
    got = spans.read(stretch(events))
    assert got["serve.prefill/model.ssm"] == row(1, 50.0, 2.0, 1)
    assert got["serve.prefill/model.ssm/kernels.ssd_scan.bwd"] == \
        row(1, 10.0, 3.0, 1)
    assert spans.under(got, "model.ssm") == row(1, 50.0, 5.0, 2)
    assert spans.under(got, "model.ssm", within="serve.decode_step") is None


def launch(t, dev_us):
    """A kernel launched at ``t`` that runs ``dev_us`` on the device."""
    return [X("cuda_runtime", "cudaLaunchKernel", t, 0.5),
            X("kernel", "k", t + 0.1, dev_us, tid=7)]


def train_stretch(optim_us):
    """Two steps: a launch in no span, the flash backward's two kernels,
    the update's two of ``optim_us`` each."""
    events = [X("user_annotation", "bench.stretch", 0, 300)]
    for b in (0, 100):
        events += launch(b + 1, 9.0)
        events += [X("user_annotation", "kernels.flash_attention.bwd",
                     b + 10, 10, tid=2)]
        events += launch(b + 11, 5e4) + launch(b + 12, 5e4)
        events += [X("user_annotation", "optim.update", b + 30, 30)]
        events += launch(b + 31, optim_us) + launch(b + 32, optim_us)
    return dict(stretch(events), steps=2)


def serve_stretch():
    """Two requests: a prefill with two SSM mixers and a launch between
    them, then four decode steps with a mixer and a launch each."""
    events = [X("user_annotation", "bench.stretch", 0, 3000)]
    for b in (0, 1000):
        events += [X("user_annotation", "serve.prefill", b, 100),
                   X("user_annotation", "model.ssm", b + 10, 10),
                   X("user_annotation", "model.ssm", b + 30, 10)]
        events += launch(b + 11, 1e5) + launch(b + 31, 1e5)
        events += launch(b + 50, 7.0)
        for k in range(4):
            t = b + 200 + 50 * k
            events += [X("user_annotation", "serve.decode_step", t, 40),
                       X("user_annotation", "model.ssm", t + 5, 10)]
            events += launch(t + 6, 2000.0) + launch(t + 20, 1000.0)
    return dict(stretch(events), requests=2)


TRAIN = {"kind": "train", "stretches": [train_stretch(1e5)]}
SERVE = {"kind": "serve", "traffic": {"new_tokens": 4},
         "stretches": [serve_stretch()]}


def reader(name):
    return harness.metric_reader(name).read


def test_train_readers():
    assert reader("optimizer_ms.train")(TRAIN) == pytest.approx(200.0)
    assert reader("attn_bwd_ms.train")(TRAIN) == pytest.approx(100.0)
    two = {"kind": "train",
           "stretches": TRAIN["stretches"] + [train_stretch(5e4)]}
    assert reader("optimizer_ms.train")(two) == pytest.approx(150.0)


def test_serve_readers():
    assert reader("decode_device_ms.serve")(SERVE) == pytest.approx(3.0)
    assert reader("decode_launches.serve")(SERVE) == pytest.approx(2.0)
    assert reader("ssm_mixer_ms.serve")(SERVE) == pytest.approx(200.0)


def without_spans(st: dict) -> dict:
    """``st`` as a program without spans leaves it: the same launches and
    operations, no program span among the host's."""
    return dict(st, host=[h for h in st["host"]
                          if not h[0].startswith(spans.PREFIXES)])


@pytest.mark.parametrize("name", ["optimizer_ms.train", "attn_bwd_ms.train",
                                  "decode_device_ms.serve",
                                  "decode_launches.serve",
                                  "ssm_mixer_ms.serve"])
def test_readers_find_nothing_without_spans(name):
    read = reader(name)
    for r in (TRAIN, SERVE):
        bare = dict(r, stretches=[without_spans(st)
                                  for st in r["stretches"]])
        assert read(bare) is None
        assert read(dict(r, stretches=[])) is None
    assert read({"kind": "serve", "window": {}}) is None
    other = TRAIN if name.endswith(".serve") else SERVE
    assert read(other) is None
