"""The port's dry run (``repro_torch.launch.dryrun``), all on ``meta``
tensors: one host process as one rank of a fake world.

Covers: the sharded decode at (data, model) = (1, 4) on a fake world of 4,
at full width, records the collective counts the card's profiler counted
(PERF.md §5: 1057 a step for mistral-large-123b's 88 layers, 257 for
jamba-v0.1-52b's 32), each one a c10d op; glm4-9b ``decode_32k`` lowers on
the fake 16 x 16 world through the CLI and writes every key of the
reference's result plus ``program``, ``fits`` and ``source``; a cell the
port refuses is written with its message; phi4-mini's ``train_4k``, whose
24 query heads 16 does not divide, traces with a roofline; the kernels'
meta route refuses what the card refuses (bf16 flash at head dim 8) and
launches nothing; the guard reads a meta flag as a clean step.  A model
axis larger than the head count (64 over glm4-9b's 32 query heads and
mamba2-370m's 32 SSM heads) leaves ranks 32-63 empty head blocks: rank 63
traces serving and training with no flash or SSD call and the same
collectives as rank 0, and the meta wrappers return the kernels' empty
shapes.
"""

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as launch_mesh
from repro_torch.resilience.guard import apply_guard, host_flag
from repro_torch.sharding import Policy

REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "params_B",
                  "active_params_B", "memory", "collectives", "roofline"}
MEMORY_KEYS = {"argument_GiB", "output_GiB", "temp_GiB", "alias_GiB",
               "peak_per_device_GiB"}


@pytest.mark.parametrize("arch, count", [("mistral-large-123b", 1057),
                                         ("jamba-v0.1-52b", 257)])
def test_sharded_decode_records_the_cards_collective_count(arch, count):
    launch_mesh.init_fake_world(0, 4)
    try:
        mesh = launch_mesh.make_host_mesh((1, 4), device="meta")
        tr = dryrun.trace_serve(get_config(arch), batch=4, prompt_len=1024,
                                policy=Policy.for_mesh(mesh), kind="decode")
    finally:
        dist.destroy_process_group()
    coll = [r for r in tr.records if r.kind == "collective"]
    assert len(coll) == count
    assert sum(tr.c10d.values()) == count   # each one c10d op, as profiled
    assert {r.ranks for r in coll} == {(0, 1, 2, 3)}


def test_glm4_decode_32k_writes_every_key(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.main(["--arch", "glm4-9b", "--shape", "decode_32k"])
    res = json.loads((tmp_path / "16x16" / "glm4-9b__decode_32k.json")
                     .read_text())
    assert REFERENCE_KEYS | {"program", "fits", "source", "trace_s"} <= \
        set(res)
    assert set(res["memory"]) == MEMORY_KEYS
    assert res["chips"] == 256 and res["refused"] is None
    assert res["fits"] is True and res["memory"]["peak_per_device_GiB"] > 0
    assert res["source"].endswith("not measured")
    assert res["collectives"]["counts"]["all-reduce"] > 0
    assert res["collectives"]["c10d_ops"] == \
        sum(res["collectives"]["counts"].values())
    assert res["roofline"]["t_memory_s"] > 0
    assert not dist.is_initialized()


def test_a_refused_cell_is_written_with_the_ports_message(monkeypatch):
    """A width the policy train program splits over the model axis and
    the axis does not divide, here jamba's experts set to 24 over 16, is
    refused by name and the cell written with the port's message (every
    cell of the 16 x 16 sweep is traced: query heads split by the
    balanced decomposition)."""
    from repro_torch import configs
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                num_experts=24)
    monkeypatch.setattr(configs, "get_config", lambda arch: jamba)
    res = dryrun.lower_cell("jamba-v0.1-52b", "train_4k", verbose=False)
    assert res["refused"].startswith(
        "NotImplementedError: the policy train program")
    assert "'num_experts': 24" in res["refused"]
    assert REFERENCE_KEYS | {"program", "fits", "source"} <= set(res)
    assert res["roofline"] is None and not dist.is_initialized()


def test_phi4_mini_train_4k_is_traced_with_a_roofline():
    """phi4-mini's 24 query heads over the model axis's 16 (ranks 0-7
    hold 2, ranks 8-15 one): its ``train_4k`` cell runs the policy train
    program, one flash call a layer in the forward and again in the
    remat, and has memory, fits, collectives and a roofline."""
    res = dryrun.lower_cell("phi4-mini-3.8b", "train_4k", verbose=False)
    assert res["refused"] is None and "ZeRO-3" in res["program"]
    assert res["kernel_calls"]["flash_attention"] == 2 * 32
    assert res["fits"] is True and res["memory"]["peak_per_device_GiB"] > 0
    assert res["collectives"]["counts"]["all-gather"] > 0
    assert res["roofline"]["t_bound_s"] > 0
    assert not dist.is_initialized()


def test_glm4_train_4k_is_traced_under_zero3():
    """glm4-9b's ``train_4k`` at 16 x 16 runs the policy train program:
    each rank's parameters and moments (the trace's arguments) are 1/256
    of every leaf that (data, model) divides, plus the leaves the policy
    leaves whole on some axis, counted at their blocks; the peak is below
    the same state held whole."""
    from repro_torch.launch.specs import param_specs
    from repro_torch.models.model import train_param_specs
    res = dryrun.lower_cell("glm4-9b", "train_4k", verbose=False)
    assert res["refused"] is None and "ZeRO-3" in res["program"]
    assert res["kernel_calls"] == {"flash_attention": 80, "rmsnorm": 161}
    launch_mesh.init_fake_world(0, 256)
    try:
        pol = dryrun.make_policy(launch_mesh.make_production_mesh(
            device="meta"))
        specs = train_param_specs(get_config("glm4-9b"), pol)
    finally:
        dist.destroy_process_group()
    # bf16 parameters and fp32 AdamW moments: 10 bytes an element
    full = mine = whole = 0
    for k, v in param_specs(get_config("glm4-9b")).items():
        k_bytes = v.numel() * (v.element_size() + 8)
        n = 1
        for e in specs[k]:
            for a in ((e,) if isinstance(e, str) else e or ()):
                n *= 16
        full += k_bytes
        mine += k_bytes // n
        if n == 1:
            assert "norm" in k, k      # only the norm weights stay whole
            whole += k_bytes
    got = res["memory"]["argument_GiB"] * 2**30
    assert got == mine
    assert 0 <= got - full / 256 <= whole
    assert res["memory"]["peak_per_device_GiB"] * 2**30 < full


def test_meta_route_refuses_what_the_card_refuses():
    q = torch.empty(1, 64, 4, 8, dtype=torch.bfloat16, device="meta")
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="head dim 8 not in") as meta:
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError) as card:
        flash.check_inputs(q, q, q, device="meta")
    assert str(meta.value) == str(card.value)
    q = torch.empty(1, 64, 4, 64, dtype=torch.bfloat16, device="meta")
    assert ops.flash_attention(q, q, q).device.type == "meta"
    assert ops.LAUNCHES == before


@pytest.fixture(scope="module")
def empty_block_cells():
    """``mesh_cell`` at (1, 64), one layer, batch 1, seq 256, for glm4-9b
    and mamba2-370m served and trained, on rank 63 (no head) and rank 0."""
    return {(arch, kind, rank): dryrun.mesh_cell(arch, 1, 1, 256, (1, 64),
                                                 rank=rank, kind=kind)
            for arch in ("glm4-9b", "mamba2-370m")
            for kind in ("serve", "train") for rank in (63, 0)}


@pytest.mark.parametrize("arch, kernel", [("glm4-9b", "flash_attention"),
                                          ("mamba2-370m", "ssd_scan")])
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_rank_with_no_head_traces_every_collective(empty_block_cells,
                                                     arch, kernel, kind):
    """Rank 63 of a 64-way model axis holds no query or SSM head: it calls
    no flash or SSD kernel (its sublayer contributes zero) and takes part
    in every collective rank 0 takes, with zero-size blocks."""
    empty = empty_block_cells[(arch, kind, 63)]
    full = empty_block_cells[(arch, kind, 0)]
    assert kernel not in empty["kernel_calls"]
    assert full["kernel_calls"][kernel] >= 1
    assert empty["kernel_calls"]["rmsnorm"] == full["kernel_calls"]["rmsnorm"]
    assert empty["collectives"]["counts"] == full["collectives"]["counts"]
    assert empty["collectives"]["c10d_ops"] == full["collectives"]["c10d_ops"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_wrappers_return_empty_head_blocks(dtype):
    """An empty head block on ``meta``: flash (H = KH = 0) and the SSD scan
    (H = 0) return the kernels' shapes, record no kernel call and launch
    nothing; any other shape is still refused."""
    from repro_torch.roofline.hlo_profile import Trace
    q = torch.empty(2, 64, 0, 128, dtype=dtype, device="meta")
    x = torch.empty(2, 64, 0, 64, dtype=dtype, device="meta")
    dt = torch.empty(2, 64, 0, device="meta")
    a_neg = torch.empty(0, device="meta")
    bm = torch.empty(2, 64, 128, dtype=dtype, device="meta")
    before = dict(ops.LAUNCHES)
    with Trace() as tr:
        o = ops.flash_attention(q, q, q)
        y, h = ops.ssd_scan(x, dt, a_neg, bm, bm)
    assert (o.shape, y.shape, h.shape) == ((2, 64, 0, 128), (2, 64, 0, 64),
                                           (2, 0, 64, 128))
    assert (o.dtype, y.dtype, h.dtype) == (dtype, dtype, torch.float32)
    assert o.device.type == y.device.type == h.device.type == "meta"
    assert not [r for r in tr.records if r.kind == "kernel"]
    assert ops.LAUNCHES == before
    k = torch.empty(2, 64, 2, 128, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="query heads do not group"):
        ops.flash_attention(k, q, q)          # 2 query heads over 0 K/V
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_scan(x[..., :48], dt, a_neg, bm, bm)


def test_a_meta_flag_passes_the_guard_as_a_clean_step():
    flag = torch.ones((), dtype=torch.int32, device="meta")
    assert host_flag(flag) == 0 and host_flag(torch.tensor(1)) == 1
    state = {"params": "old", "opt": "old-moments", "step": 3,
             "skipped_steps": 1}
    assert apply_guard(flag, state, "new", "new-moments") == {
        "params": "new", "opt": "new-moments", "step": 4,
        "skipped_steps": 1}
    cfg = dataclasses.replace(reduced(get_config("glm4-9b")),
                              dtype="bfloat16")
    tr = dryrun.trace_train(cfg, batch=2, seq=32)
    assert {r.op for r in tr.records if r.kind == "kernel"} == \
        {"flash_attention", "rmsnorm"}
