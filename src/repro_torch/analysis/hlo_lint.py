"""Anti-pattern lint over a traced step of the port (mirrors
``repro/analysis/hlo_lint.py``; DESIGN §7).

Torch compiles no HLO, so the rules read what the port's own programs
do: the shape trace of ``roofline/hlo_profile.py``, one ``OpRecord`` per
aten op, kernel call and collective (the collectives recorded by
``core/primitives.py`` with their mesh axis, group ranks, shapes and dim).
Each rule emits structured :class:`Finding` records (rule id, severity,
op, bytes, the record's index in the trace as ``lineno``):

``seq-dim-allgather``    an all-gather that brings the sequence dim to
                         ``seq_len`` from a smaller size while context
                         parallelism is live.
``divergent-collective`` the eager form of the SPMD deadlock class: ranks
                         of one group issued different collective
                         sequences on it (compared over per-rank traces;
                         a fake world traces a divergent program without
                         hanging).
``adjacent-allreduce``   two all-reduces on one group with no aten op
                         between them (combinable into one).
``missing-grad-reduce``  an axis the caller declares a gradient sum over
                         has no all-reduce on it (drain-tail sum lost).
``activation-budget``    the largest rank-3+ output exceeds the declared
                         ``attention_working_set_bytes`` budget.

Entry points: ``lint_trace(records, ...)`` and ``python -m
repro_torch.analysis.hlo_lint --quickstart`` (8 gloo ranks: the CP hybrid
train step lints error-clean, and a program that all-gathers the sequence
dim over ``model`` with ctx declared live fires the seq-dim rule, the
forced violation).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.roofline.hlo_profile import (peak_activation_bytes,
                                              seq_gather_bytes)

__all__ = ["Finding", "RULES", "lint_trace", "format_findings"]

RULES = {
    "seq-dim-allgather": "sequence-dim all-gather while ctx is live",
    "divergent-collective": "ranks of one group issue different collectives",
    "adjacent-allreduce": "back-to-back unfused all-reduces",
    "missing-grad-reduce": "declared gradient psum absent from module",
    "activation-budget": "peak activation exceeds declared budget",
}


@dataclass(frozen=True)
class Finding:
    """One structured lint finding over a traced step."""

    rule: str
    severity: str
    message: str
    opcode: str = ""
    bytes: int = 0
    lineno: int = 0

    def to_dict(self) -> dict:
        """Plain-dict form for JSON artifacts."""
        return asdict(self)


def _collectives_on(records, group) -> list:
    return [r for r in records if r.kind == "collective" and r.ranks == group]


def _check_divergent_collectives(rank_traces) -> list:
    """Groups whose member ranks (among those traced) issued different
    collective sequences on them: the ranks that wait for a collective
    their peers never issue deadlock."""
    out = []
    groups = sorted({r.ranks for recs in rank_traces.values()
                     for r in recs if r.kind == "collective"})
    for group in groups:
        seqs = {rank: _collectives_on(rank_traces[rank], group)
                for rank in group if rank in rank_traces}
        if len(seqs) < 2:
            continue
        (a, sa), *rest = sorted(seqs.items())
        for b, sb in rest:
            sig_a = [(r.op, r.out_shapes, r.dtype) for r in sa]
            sig_b = [(r.op, r.out_shapes, r.dtype) for r in sb]
            if sig_a == sig_b:
                continue
            i = next((j for j, (x, y) in enumerate(zip(sig_a, sig_b))
                      if x != y), min(len(sig_a), len(sig_b)))
            rec = sa[i] if i < len(sa) else sb[i]
            op_a, op_b = (s[i][0] if i < len(s) else "nothing"
                          for s in (sig_a, sig_b))
            out.append(Finding(
                "divergent-collective", "error",
                f"ranks {a} and {b} of group {list(group)} issue different "
                f"collectives at their #{i} on it ({op_a} vs {op_b}) — the "
                f"waiting ranks deadlock",
                opcode=rec.op, bytes=rec.out_bytes, lineno=rec.index))
            break
    return out


def _check_adjacent_allreduce(records) -> list:
    """Consecutive all-reduce records on one group with no aten op in
    between (combinable)."""
    out = []
    prev = None
    for rec in records:
        if rec.kind != "collective":
            continue
        if (prev is not None and rec.op == "all-reduce"
                and prev.op == "all-reduce" and rec.ranks == prev.ranks
                and rec.pos == prev.pos):
            out.append(Finding(
                "adjacent-allreduce", "warning",
                f"adjacent all-reduces at records {prev.index},{rec.index} "
                f"on '{rec.axis}' — combinable into one",
                opcode="all-reduce", bytes=prev.out_bytes + rec.out_bytes,
                lineno=rec.index))
        prev = rec
    return out


def lint_trace(records, *, seq_len: int | None = None,
               ctx_live: bool = False, grad_reduce_axes=(),
               activation_budget_bytes: int | None = None,
               rank_traces: dict | None = None) -> list:
    """Run every applicable rule over one rank's traced ``records``.

    ``seq_len``/``ctx_live`` arm the sequence-gather rule; a non-empty
    ``grad_reduce_axes`` declares the mesh axes whose gradient sums MUST
    appear (the pipeline drain-tail); ``activation_budget_bytes`` arms the
    working-set budget rule; ``rank_traces`` (rank -> records, this rank's
    among them) arms the divergent-collective rule.  Returns ``Finding``
    records, errors first.
    """
    records = getattr(records, "records", records)
    findings = []
    if ctx_live and seq_len is not None:
        for rec in records:
            b = seq_gather_bytes(rec, seq_len)
            if b:
                findings.append(Finding(
                    "seq-dim-allgather", "error",
                    f"all-gather materializes the full sequence "
                    f"(S={seq_len}) while ctx is live — the SP->TP gather "
                    f"context parallelism exists to eliminate",
                    opcode=rec.op, bytes=b, lineno=rec.index))
    if rank_traces:
        findings += _check_divergent_collectives(
            {r: getattr(t, "records", t) for r, t in rank_traces.items()})
    findings += _check_adjacent_allreduce(records)
    for axis in grad_reduce_axes:
        if not any(r.kind == "collective" and r.op == "all-reduce"
                   and r.axis == axis for r in records):
            findings.append(Finding(
                "missing-grad-reduce", "error",
                f"gradient psum over axis {axis!r} is declared live but the "
                f"step issues NO all-reduce on it — drain-tail epilogue "
                f"lost?"))
    if activation_budget_bytes is not None:
        peak = peak_activation_bytes(records)
        if peak > activation_budget_bytes:
            findings.append(Finding(
                "activation-budget", "error",
                f"peak rank-3+ activation {peak} B exceeds the declared "
                f"working-set budget {activation_budget_bytes} B",
                bytes=peak))
    findings.sort(key=lambda f: (f.severity != "error", f.lineno))
    return findings


def format_findings(findings) -> str:
    """Human-readable one-line-per-finding rendering."""
    if not findings:
        return "hlo_lint: clean"
    lines = []
    for f in findings:
        loc = f":{f.lineno}" if f.lineno else ""
        by = f" [{f.bytes} B]" if f.bytes else ""
        lines.append(f"{f.severity.upper():7s} {f.rule}{loc}{by}: "
                     f"{f.message}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# --quickstart: 8 gloo ranks.
# ---------------------------------------------------------------------------

# The reference's quickstart model: S distinct from every other global
# dim so the structural check cannot alias.
QUICK = dict(name="hlo", family="dense", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
             vocab_size=256, dtype="float32", remat=False, attn_chunk=24)
QUICK_B, QUICK_S = 8, 96
QUICK_MESH = (1, 1, 4, 2, 1)     # (dp, pp, cp, tp, ep): ctx 4, model 2


def quick_batch():
    import torch
    gen = torch.Generator().manual_seed(3)
    return {k: torch.randint(0, QUICK["vocab_size"], (QUICK_B, QUICK_S),
                             generator=gen) for k in ("tokens", "labels")}


def trace_hybrid_step(cfg, fact, batch, *, nonfinite_guard=True,
                      microbatches=2):
    """Trace one hybrid train step of ``cfg`` at factorization ``fact`` on
    this rank of the current (gloo) world, every rank calling it
    together: ``(records, policy)``."""
    import torch

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import init_pipeline_params
    from repro_torch.models.convert import to_rank_params
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline.hlo_profile import Trace
    from repro_torch.sharding import Policy
    from repro_torch.train import build_hybrid_train_step, init_train_state

    dp, pp, cp, tp, ep = fact
    mesh = launch_mesh.make_hybrid_mesh(dp, pp, cp, tp, ep, device="cpu")
    policy = Policy.for_mesh(mesh, explicit_tp=tp > 1)
    opt = make_optimizer("adamw", total_steps=10)
    glob = init_pipeline_params(cfg, torch.Generator().manual_seed(0), pp,
                                "cpu")
    state = init_train_state(cfg, to_rank_params(cfg, policy, glob), opt)
    step = build_hybrid_train_step(cfg, policy, opt,
                                   num_microbatches=microbatches,
                                   nonfinite_guard=nonfinite_guard)
    with Trace() as tr:
        step(state, batch)
    return tr.records, policy


def forced_seq_gather():
    """The forced violation: the port's TP sublayer shards the residual's
    features, never the sequence, so no program of the port gathers the
    sequence dim; this short program does, an all-gather of a
    sequence-sharded residual along dim 1 over ``model``."""
    import torch

    from repro_torch.core import primitives as prim
    from repro_torch.roofline.hlo_profile import Trace
    n = prim.axis_size("model")
    x = torch.zeros((QUICK_B, QUICK_S // n, QUICK["d_model"]))
    with Trace() as tr:
        prim.all_gather(x, "model", 1)
    return tr.records


def _quickstart_rank(rank, world_mesh):
    import torch.distributed as dist

    from repro_torch.configs import ModelConfig
    records, _ = trace_hybrid_step(ModelConfig(**QUICK), QUICK_MESH,
                                   quick_batch())
    cp = [f.to_dict() for f in lint_trace(records, seq_len=QUICK_S,
                                          ctx_live=True)]
    forced = [f.to_dict() for f in lint_trace(forced_seq_gather(),
                                              seq_len=QUICK_S,
                                              ctx_live=True)]
    dist.barrier()  # repro-lint: allow (moves no data; no rank leaves early)
    return {"cp": cp, "forced": forced}


def _quickstart() -> int:
    """Trace and lint the CP hybrid train step on 8 gloo ranks and the
    forced sequence gather; the CP step must lint error-clean and the
    forced program must fire the seq-dim rule."""
    from repro_torch.launch.mesh import spawn
    out = spawn(_quickstart_rank, 8, device="cpu", timeout_s=300)
    cp = [Finding(**f) for r in out for f in r["cp"]]
    forced = [Finding(**f) for r in out for f in r["forced"]
              if f["rule"] == "seq-dim-allgather"]
    print("== CP train step (8 ranks: ctx 4 x model 2) ==")
    print(format_findings([Finding(**f) for f in out[0]["cp"]]))
    print("== forced violation: sequence all-gather, ctx declared live ==")
    print(format_findings([Finding(**f) for f in out[0]["forced"]]))
    if any(f.severity == "error" for f in cp):
        print("FAIL: CP quickstart program has lint errors")
        return 1
    if len(forced) != len(out):
        print("FAIL: forced seq-dim all-gather was not caught")
        return 1
    print("hlo_lint --quickstart: CP clean, forced violation caught")
    return 0


def main(argv=None) -> int:
    """CLI: ``--quickstart``."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quickstart", action="store_true",
                    help="trace + lint the CP train step and the forced "
                         "sequence gather on 8 gloo ranks")
    args = ap.parse_args(argv)
    if not args.quickstart:
        ap.error("need --quickstart (lint_trace lints a trace in-process)")
    return _quickstart()


if __name__ == "__main__":
    raise SystemExit(main())
