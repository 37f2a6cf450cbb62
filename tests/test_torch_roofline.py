"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``) and the kernel table's bounds.

Pure calls and meta-tensor traces: nothing is compiled, no process group.
Covers: ``model_flops`` and ``ssd_flops_fwd`` equal the reference's for
every arch and applicable shape; ``roofline_table`` renders the
reference's text for the same row and ``dryrun_table`` differs only in
its "trace" column; ``kernel_cost`` at the serving shapes gives the
kernel table's bounds (PERF.md §6) to the fourth digit; the collective
term prices a group by the link it spans; ``analyze`` counts
``FlopCounterMode``'s operations plus each kernel call's, and the trace
keeps the high-water mark of live storage bytes.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import applicable_shapes as jax_shapes
from repro.configs import get_config as jax_config
from repro.roofline import analysis as jax_roof
from repro.roofline import report as jax_report
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config
from repro_torch.kernels import ops
from repro_torch.kernels.cost import kernel_cost
from repro_torch.roofline import analysis, report
from repro_torch.roofline.hlo_profile import OpRecord, Trace

BF16 = torch.bfloat16


def test_model_flops_match_the_reference_for_every_cell():
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert applicable_shapes(cfg) == jax_shapes(jcfg)
        for shape in applicable_shapes(cfg):
            assert analysis.model_flops(cfg, shape) == \
                jax_roof.model_flops(jcfg, shape), (arch, shape)
        for B, S in ((1, 64), (8, 2048)):
            assert analysis.ssd_flops_fwd(cfg, B, S) == \
                jax_roof.ssd_flops_fwd(jcfg, B, S), arch


def _row():
    roof = analysis.Roofline(flops=3.1e12, bytes_accessed=5.2e11,
                             coll_bytes=7.5e9, model_flops=6.4e14,
                             chips=256, t_compute=3.1e12 / 989e12,
                             t_collective=7.5e9 / 450e9).as_dict()
    assert set(roof) == set(jax_roof.Roofline(1, 1, 1, 1, 1).as_dict())
    return {"arch": "glm4-9b", "shape": "train_4k", "mesh": "16x16",
            "compile_s": 12.0, "trace_s": 12.0,
            "memory": {"peak_per_device_GiB": 41.25, "argument_GiB": 20.5,
                       "temp_GiB": 20.75},
            "collectives": {"counts": {"all-reduce": 3, "all-gather": 7}},
            "roofline": roof}


def test_report_tables_render_the_reference_text():
    rows = [_row()]
    assert report.roofline_table(rows) == jax_report.roofline_table(rows)
    assert report.dryrun_table(rows) == \
        jax_report.dryrun_table(rows).replace("| compile |", "| trace |")
    refused = dict(_row(), refused="SystemExit: no", program="hybrid")
    assert report.roofline_table(rows + [refused]) == \
        report.roofline_table(rows)
    assert "SystemExit: no" in report.refused_table([refused])


def test_kernel_cost_gives_the_kernel_tables_bounds():
    """PERF.md §6's bound column at the serving shapes: flash q
    (4,1024,32,128), k/v (4,1024,2,128) causal; RMSNorm x (4096,4096)
    bf16, w fp32; SSD x (8,2048,32,64), B/C (8,2048,128), chunk 64."""
    def ms(name, *shapes, **kw):
        cost = kernel_cost(name, *shapes, dtype=BF16, **kw)
        return round(analysis.bound(cost, BF16)["bound_ms"], 4)

    assert ms("flash_attention", (4, 1024, 32, 128), (4, 1024, 2, 128),
              (4, 1024, 2, 128)) == 0.0348
    assert ms("rmsnorm", (4096, 4096), (4096,)) == 0.0200
    assert ms("ssd_scan", (8, 2048, 32, 64), (8, 2048, 32), (32,),
              (8, 2048, 128), (8, 2048, 128), chunk=64) == 0.0457
    fp32 = kernel_cost("flash_attention", (1, 8, 2, 16), (1, 8, 2, 16),
                       (1, 8, 2, 16), dtype=torch.float32, causal=False)
    assert fp32 == {"flops": 4 * 2 * 16 * 64, "bytes": 4 * 4 * 256}
    assert analysis.bound(fp32, torch.float32)["flops_ms"] == \
        fp32["flops"] / 67e12 * 1e3


def test_tf32x3_kernels_are_priced_at_three_tf32_passes():
    """The TF32 column is half the bf16 one on each form factor; a kernel
    call on the ``tf32x3`` route (fp32 work as three TF32 products) is
    priced at 3 x its operations over it, in ``bound`` and in ``analyze``,
    while an aten fp32 matmul stays at the fp32 rate (TF32 is off for
    them) and bf16 kernel calls at the bf16 rate, to the last digit."""
    assert {k: v[3] for k, v in analysis.PEAKS.items()} == {
        "H100 SXM": 494.5e12, "H100 PCIe": 378e12, "H100 NVL": 417.5e12}
    assert all(v[3] == v[1] / 2 for v in analysis.PEAKS.values())
    shapes = ((4, 1024, 32, 128), (4, 1024, 2, 128), (4, 1024, 2, 128))
    fp32 = kernel_cost("flash_attention", *shapes, dtype=torch.float32)
    tf32 = analysis.bound(fp32, torch.float32, route="tf32x3")
    assert tf32["flops_ms"] == fp32["flops"] / (494.5e12 / 3) * 1e3
    assert round(tf32["bound_ms"], 4) == 0.2087       # PERF.md §6
    assert round(analysis.bound(fp32, torch.float32)["bound_ms"], 4) == 0.5133
    ssd = kernel_cost("ssd_scan", (8, 2048, 32, 64), (8, 2048, 32), (32,),
                      (8, 2048, 128), (8, 2048, 128), dtype=torch.float32)
    assert round(analysis.bound(ssd, torch.float32,
                                route="tf32x3")["bound_ms"], 4) == 0.1319
    bf16 = kernel_cost("flash_attention", *shapes, dtype=BF16)
    assert analysis.bound(bf16, BF16, route="tensor_core") == \
        analysis.bound(bf16, BF16)
    assert analysis.bound(bf16, BF16)["flops_ms"] == \
        bf16["flops"] / 989e12 * 1e3

    def rec(route, dtype, flops):
        return OpRecord("kernel", "flash_attention", 0, ((1,),), ((1,),),
                        dtype, flops=flops, route=route)

    recs = [rec("tf32x3", "float32", 3e9), rec("tensor_core", "bfloat16", 5e9),
            OpRecord("aten", "aten.mm", 0, ((1,),), ((1,),), "float32",
                     flops=7e9)]
    roof = analysis.analyze(recs, get_config("glm4-9b"), "train_4k", 1)
    assert roof.t_compute == 3 * 3e9 / 494.5e12 + 5e9 / 989e12 + 7e9 / 67e12


def test_collectives_are_priced_by_the_link_their_group_spans():
    assert analysis.link_bw(range(8)) == analysis.NVLINK_BW
    assert analysis.link_bw(range(16)) == analysis.NIC_BW
    assert analysis.link_bw(range(0, 256, 16)) == analysis.NIC_BW

    def rec(op, ranks, nbytes):
        return OpRecord("collective", op, 0, ((1,),), ((1,),), "float32",
                        out_bytes=nbytes, ranks=tuple(ranks))

    recs = [rec("all-reduce", range(8), 900), rec("all-gather", range(16),
                                                   100),
            rec("all-reduce", range(8, 16), 50)]
    assert analysis.collective_bytes(recs) == {
        "bytes": {"all-reduce": 950, "all-gather": 100},
        "counts": {"all-reduce": 2, "all-gather": 1}, "total_bytes": 1050}
    roof = analysis.analyze(recs, get_config("glm4-9b"), "train_4k", 256)
    assert roof.t_collective == pytest.approx(950 / 450e9 + 100 / 50e9)
    assert roof.bottleneck == "collective"


def test_analyze_counts_aten_flops_and_kernel_costs_on_meta():
    a = torch.empty(64, 128, device="meta", dtype=BF16)
    b = torch.empty(128, 32, device="meta", dtype=BF16)
    x = torch.empty(16, 256, device="meta", dtype=BF16)
    w = torch.empty(256, device="meta")
    with FlopCounterMode(display=False) as fc:
        a @ b
    before = dict(ops.LAUNCHES)
    with Trace() as tr:
        c = a @ b
        ops.rmsnorm(x, w)
    assert ops.LAUNCHES == before   # the meta route launches nothing
    kernel = [r for r in tr.records if r.kind == "kernel"]
    assert [(r.op, r.route) for r in kernel] == [("rmsnorm", "triton")]
    norm = kernel_cost("rmsnorm", x.shape, w.shape, dtype=BF16)
    roof = analysis.analyze(tr, get_config("glm4-9b"), "prefill_32k", 1)
    assert roof.flops == fc.get_total_flops() + norm["flops"]
    mm = 2 * (64 * 128 + 128 * 32 + 64 * 32)
    assert roof.bytes_accessed == mm + norm["bytes"]
    assert roof.t_compute == pytest.approx(
        (fc.get_total_flops() + norm["flops"]) / 989e12)
    assert c.shape == (64, 32)


def test_the_trace_keeps_the_peak_of_live_storage_bytes():
    w = torch.empty(1024, 1024)                    # 4 MiB, adopted
    with Trace().adopt([w]) as tr:
        y = torch.empty(1024, 256)                 # +1 MiB
        z = y.view(256, 1024)                      # a view: no new storage
        del y, z                                   # -1 MiB
        t = torch.empty(512, 1024)                 # +2 MiB
    assert tr.argument_bytes == 4 << 20
    assert tr.peak_bytes == 6 << 20
    assert tr.live_bytes == 6 << 20 and t.numel() == 512 * 1024


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gather_backward_counts_its_zero_buffer_once(device):
    """Under the trace (a dispatch mode) ``gather``'s backward takes the
    out-of-place ``scatter_add`` on a fresh zero buffer, where a run
    without a mode fills that buffer in place: the trace counts the
    gradient in the buffer's place, so its peak is x and x's gradient
    (4 MiB each), not a third buffer as well."""
    x = torch.zeros(1024, 1024, device=device, requires_grad=True)
    idx = torch.zeros(1024, 1, dtype=torch.long, device=device)
    tr = Trace().adopt([x])
    with tr:
        (g,) = torch.autograd.grad(x.gather(1, idx).sum(), x)
    assert any(r.op == "aten.scatter_add" for r in tr.records)
    assert 8 << 20 <= tr.peak_bytes < 9 << 20, tr.peak_bytes
    assert g.shape == x.shape
