"""The port's lint over traced steps (``repro_torch.analysis.hlo_lint``),
the counterpart of tests/test_hlo_lint.py and of the reference's
``--quickstart`` and guard-inventory checks
(tests/md/test_resilience_md.py).

Each rule fires on a hand-built record list (where the reference writes
HLO text by hand) and ``format_findings`` renders the reference's text for
the same findings.  One pool of 8 gloo ranks traces real programs: the CP
hybrid train step (ctx 4 x model 2) lints error-clean with no sequence
all-gather, the forced sequence gather fires the seq-dim rule, and the
guarded step's collective inventory is the unguarded one's plus exactly
one all-reduce.  A program that diverges on one rank, traced on a fake
world, fires divergent-collective.
"""

import torch
import torch.distributed as dist

from repro.analysis import hlo_lint as jax_lint
from repro_torch.analysis import Finding, lint_trace
from repro_torch.analysis.hlo_lint import (RULES, QUICK, QUICK_MESH,
                                           QUICK_S, format_findings,
                                           forced_seq_gather, quick_batch,
                                           trace_hybrid_step)
from repro_torch.configs import ModelConfig
from repro_torch.core import primitives as prim
from repro_torch.launch import mesh as launch_mesh
from repro_torch.roofline.hlo_profile import (OpRecord, Trace,
                                              collective_inventory,
                                              seq_dim_allgather_bytes)


def _coll(index, op, ins, outs, *, pos=0, ranks=(0, 1), axis="model",
          dim=None):
    return OpRecord("collective", op, index, (ins,), (outs,), "float32",
                    out_bytes=4 * torch.Size(outs).numel(), axis=axis,
                    ranks=ranks, dim=dim, pos=pos)


def _aten(index, shape, pos):
    return OpRecord("aten", "aten.mul", index, (shape,), (shape,),
                    "float32", pos=pos)


def test_rules_match_the_reference():
    assert set(RULES) == set(jax_lint.RULES)
    fs = [Finding("seq-dim-allgather", "error", "m", "all-gather", 9, 3),
          Finding("adjacent-allreduce", "warning", "w", "all-reduce", 0, 0)]
    ref = [jax_lint.Finding(**f.to_dict()) for f in fs]
    assert format_findings(fs) == jax_lint.format_findings(ref)
    assert format_findings([]) == jax_lint.format_findings([])


def test_seq_dim_allgather_fires_only_on_a_sequence_gather():
    gather = _coll(1, "all-gather", (8, 12, 64), (8, 96, 64), dim=1)
    feature = _coll(2, "all-gather", (8, 96, 8), (8, 96, 64), dim=2)
    recs = [_aten(0, (8, 12, 64), 0), gather, feature]
    (f,) = lint_trace(recs, seq_len=96, ctx_live=True)
    assert (f.rule, f.severity, f.bytes, f.lineno) == \
        ("seq-dim-allgather", "error", 4 * 8 * 96 * 64, 1)
    assert lint_trace(recs, seq_len=96, ctx_live=False) == []
    assert seq_dim_allgather_bytes([feature], 96) == 0


def test_adjacent_allreduce_needs_one_group_and_no_op_between():
    a = _coll(0, "all-reduce", (4, 4), (4, 4), pos=0)
    b = _coll(1, "all-reduce", (4, 4), (4, 4), pos=0)
    (f,) = lint_trace([a, b])
    assert (f.rule, f.severity, f.lineno) == ("adjacent-allreduce",
                                              "warning", 1)
    after_op = [a, _aten(1, (4, 4), 0), _coll(2, "all-reduce", (4, 4),
                                               (4, 4), pos=1)]
    other_group = [a, _coll(1, "all-reduce", (4, 4), (4, 4), pos=0,
                            ranks=(0, 2))]
    assert lint_trace(after_op) == [] and lint_trace(other_group) == []


def test_missing_grad_reduce_and_activation_budget():
    recs = [_coll(0, "all-reduce", (4,), (4,), axis="data"),
            _aten(1, (2, 64, 64), 0)]
    assert lint_trace(recs, grad_reduce_axes=("data",)) == []
    (f,) = lint_trace(recs, grad_reduce_axes=("data", "ctx"))
    assert (f.rule, f.severity) == ("missing-grad-reduce", "error")
    (g,) = lint_trace(recs, activation_budget_bytes=1000)
    assert (g.rule, g.bytes) == ("activation-budget", 4 * 2 * 64 * 64)
    assert lint_trace(recs, activation_budget_bytes=1 << 20) == []


def _divergent_trace(rank):
    """Rank ``rank`` of a fake world of 2: both all-reduce over the world,
    rank 1 once more (the branch a data-dependent ``if`` takes)."""
    launch_mesh.init_fake_world(rank, 2)
    try:
        mesh = launch_mesh.make_host_mesh((2,), ("model",), device="meta")
        x = torch.empty(4, 8, device="meta")
        with prim.use_mesh(mesh), Trace() as tr:
            prim.all_reduce(x, "model")
            if rank == 1:
                prim.all_reduce(x, "model")
    finally:
        dist.destroy_process_group()
    return tr.records


def test_a_divergent_program_fires_divergent_collective():
    traces = {r: _divergent_trace(r) for r in (0, 1)}
    (f,) = [f for f in lint_trace(traces[0], rank_traces=traces)
            if f.severity == "error"]
    assert (f.rule, f.opcode) == ("divergent-collective", "all-reduce")
    same = {0: traces[0], 1: traces[0]}
    assert lint_trace(traces[0], rank_traces=same) == []


def _pool_rank(rank, world_mesh):
    cfg = ModelConfig(**QUICK)
    batch = quick_batch()
    guarded, _ = trace_hybrid_step(cfg, QUICK_MESH, batch, microbatches=1)
    unguarded, _ = trace_hybrid_step(cfg, QUICK_MESH, batch, microbatches=1,
                                     nonfinite_guard=False)
    forced = forced_seq_gather()
    dist.barrier()  # repro-lint: allow (no rank leaves early)
    inv = {name: {k: v[0] for k, v in collective_inventory(recs).items()}
           for name, recs in (("guarded", guarded),
                              ("unguarded", unguarded))}
    return {"errors": [f.to_dict() for f in lint_trace(
                guarded, seq_len=QUICK_S, ctx_live=True,
                grad_reduce_axes=("ctx",)) if f.severity == "error"],
            "seq_gather": seq_dim_allgather_bytes(guarded, QUICK_S),
            "forced": [f.rule for f in lint_trace(forced, seq_len=QUICK_S,
                                                  ctx_live=True)],
            **inv}


def test_quickstart_programs_on_8_gloo_ranks():
    out = launch_mesh.spawn(_pool_rank, 8, device="cpu", timeout_s=300)
    for rank in out:
        assert rank["errors"] == [], rank["errors"]
        assert rank["seq_gather"] == 0
        assert rank["forced"] == ["seq-dim-allgather"]
        g, u = rank["guarded"], rank["unguarded"]
        delta = {k: g.get(k, 0) - u.get(k, 0) for k in set(g) | set(u)}
        assert {k: v for k, v in delta.items() if v} == {"all-reduce": 1}
