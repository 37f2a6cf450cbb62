"""The shape trace of one step of the port's programs, and the structural
reports over it (mirrors ``repro/roofline/hlo_profile.py``).

Torch compiles no HLO, so where the reference parses the partitioned
module the port observes its own programs as they run: :class:`Trace`, a
``TorchDispatchMode``, records one :class:`OpRecord` per aten op (shapes,
dtype, bytes read and written, ``torch.utils.flop_counter``'s operations),
and the two layers below it add theirs while a trace is active
(through the registry's hooks, ``repro_torch/tracing.py``): each
hand-written kernel call (``kernels/ops.py``, with its
``kernels.cost.kernel_cost``) and each collective the primitives issue
(``core/primitives.py``: kind, mesh axis, the group's global ranks, in and
out shapes, dim, output bytes, and its position among the aten ops).  The trace runs on ``meta`` tensors (the dry run: nothing is
allocated, every layer is counted) and on card tensors alike.  It also
keeps the high-water mark of live storage bytes (each storage counted
once, released when torch frees it), the peak memory of the traced rank.

The list of records is THE view every consumer shares: the reports here,
``roofline.analysis`` and the lint rules of ``analysis/hlo_lint.py``.
Recording costs one list check when no trace is active.

  PYTHONPATH=src python -m repro_torch.roofline.hlo_profile --arch X --shape Y
"""

from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry as _FLOPS

from .. import tracing

# ops that allocate without writing, or only describe a tensor
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
# A backward formula that fills a fresh zero buffer in place on the card
# (``gather``'s: ``zeros.scatter_add_``) takes the out-of-place variant
# under any dispatch mode, this trace's included, as it does for a tensor
# subclass (``isTensorSubclassLike``); the trace counts such an op as the
# card runs it, its output in the zero buffer's place.
_FILLS_ZEROS = {"scatter_add"}
_ZEROS = {"zeros", "new_zeros", "zeros_like"}


@dataclass(frozen=True)
class OpRecord:
    """One traced op: an aten op, a kernel call or a collective."""

    kind: str                # "aten" | "kernel" | "collective"
    op: str                  # aten op, kernel name, or collective kind
    index: int               # position in the trace
    in_shapes: tuple
    out_shapes: tuple
    dtype: str
    in_bytes: int = 0
    out_bytes: int = 0
    flops: int = 0
    route: str = ""          # a kernel's route
    axis: str = ""           # a collective's mesh axis
    ranks: tuple = ()        # a collective's group, global ranks
    dim: int | None = None   # a gather's or scatter's dim
    pos: int = 0             # aten ops recorded before it


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _dtype(tensors) -> str:
    return str(tensors[0].dtype).removeprefix("torch.") if tensors else ""


class Trace(TorchDispatchMode):
    """Record every aten op run inside ``with Trace() as tr:`` as an
    ``OpRecord`` in ``tr.records`` (kernel calls and collectives add
    theirs), and keep the live and peak storage bytes.  ``adopt`` counts
    tensors that exist before the trace (parameters, optimizer state)."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self.c10d = Counter()     # c10d ops the collectives dispatched
        self.n_aten = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0   # adopted: live before the trace
        self._live: dict[int, int] = {}
        self._zeros = None        # the storage the last op zero-filled

    # -- memory ------------------------------------------------------------
    def _hold(self, t: torch.Tensor):
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._release, key, n)

    def _release(self, key, n):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def adopt(self, *trees):
        """Count the storages of the tensors of ``trees`` as live."""
        before = self.live_bytes
        for t in _tensors(trees):
            self._hold(t)
        self.argument_bytes += self.live_bytes - before
        return self

    # -- records -----------------------------------------------------------
    def add(self, kind, op, ins, outs, **kw) -> OpRecord:
        rec = OpRecord(kind, op, len(self.records),
                       tuple(tuple(t.shape) for t in ins),
                       tuple(tuple(t.shape) for t in outs),
                       kw.pop("dtype", None) or _dtype(ins or outs),
                       pos=self.n_aten, **kw)
        self.records.append(rec)
        return rec

    def __enter__(self):
        tracing.TRACES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        tracing.TRACES.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in _FLOPS:
            # Under inference mode composite ops (matmul, einsum, to) come
            # here whole: record the ops they decompose into instead.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            # priced by the primitives' collective records
            self.c10d[func.name()] += 1
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func.overloadpacket.__name__.removesuffix("_") \
            if func._schema.is_mutable else func.overloadpacket.__name__
        if (name in _FILLS_ZEROS and not func._schema.is_mutable
                and torch._C._current_graph_task_id() != -1
                and id(ins[0].untyped_storage()) == self._zeros):
            self._release(self._zeros, ins[0].untyped_storage().nbytes())
        self._zeros = (id(outs[0].untyped_storage())
                       if name in _ZEROS and outs else None)
        for t in outs:
            self._hold(t)
        in_st = {id(t.untyped_storage()) for t in ins}
        alias = (not func._schema.is_mutable and outs
                 and all(id(t.untyped_storage()) in in_st for t in outs))
        moves = not alias and name not in _NO_TRAFFIC
        flops = 0
        count = _FLOPS.get(func.overloadpacket)
        if count is not None:
            flops = int(count(*args, **kwargs, out_val=out))
        self.add("aten", f"aten.{func.overloadpacket.__name__}", ins, outs,
                 in_bytes=sum(map(_nbytes, ins)) if moves else 0,
                 out_bytes=sum(map(_nbytes, outs)) if moves else 0,
                 flops=flops)
        self.n_aten += 1
        return out


# ---------------------------------------------------------------------------
# Reports over a trace's records.
# ---------------------------------------------------------------------------

def top_tensors(records, k: int = 20):
    """Largest op outputs (per-device bytes) by (op, shape), with counts:
    ``(total, bytes, count, op, shape)``; views, which move and hold
    nothing new, are left out."""
    agg = Counter()
    for rec in records:
        if rec.kind == "aten" and not (rec.in_bytes or rec.out_bytes):
            continue
        for shape in rec.out_shapes:
            b = _shape_bytes(shape, rec.dtype)
            if b:
                agg[(rec.op, str(shape)[:90], b)] += 1
    out = sorted(((b * c, b, c, op, s) for (op, s, b), c in agg.items()),
                 reverse=True)
    return out[:k]


def opcode_bytes(records, k: int = 15):
    """Total bytes moved per aten op (and per kernel): ``(bytes, count,
    op)``, the ops an eager step spends its memory traffic on."""
    agg = defaultdict(lambda: [0, 0])
    for rec in records:
        if rec.kind == "collective":
            continue
        agg[rec.op][0] += rec.in_bytes + rec.out_bytes
        agg[rec.op][1] += 1
    rows = sorted(((v[0], v[1], op) for op, v in agg.items()), reverse=True)
    return rows[:k]


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "collective-permute", "all-to-all")


def collective_inventory(records) -> dict:
    """Per-collective-kind ``(count, total output bytes)``: the coarse comm
    picture a mesh-factorization change shifts."""
    agg = {}
    for rec in records:
        if rec.kind == "collective":
            c, b = agg.get(rec.op, (0, 0))
            agg[rec.op] = (c + 1, b + rec.out_bytes)
    return agg


def seq_gather_bytes(rec: OpRecord, seq_len: int) -> int:
    """Bytes ``rec`` all-gathers along the sequence dimension (0 if it is
    not a gather that brings its dim to ``seq_len`` from a smaller size)."""
    if rec.kind != "collective" or rec.op != "all-gather" or rec.dim is None:
        return 0
    d = rec.dim
    out, inp = rec.out_shapes[0], rec.in_shapes[0]
    if d < len(out) and d < len(inp) and out[d] == seq_len \
            and inp[d] < seq_len:
        return rec.out_bytes
    return 0


def seq_dim_allgather_bytes(records, seq_len: int) -> int:
    """Total output bytes of all-gathers along the SEQUENCE dimension, the
    SP->TP sequence gather context parallelism exists to eliminate.  Pick
    ``seq_len`` distinct from the model's other dims so the check cannot
    alias."""
    return sum(seq_gather_bytes(rec, seq_len) for rec in records)


def _shape_bytes(shape, dtype: str) -> int:
    if not dtype:
        return 0
    n = getattr(torch, dtype).itemsize
    for d in shape:
        n *= d
    return n


def peak_activation_bytes(records, min_rank: int = 3) -> int:
    """Largest single output of rank >= ``min_rank`` (bytes): q/k/v, score
    tiles and gathered residuals are the activation-shaped values, and
    under context parallelism the largest one shrinks ~cp-fold."""
    peak = 0
    for rec in records:
        for shape in rec.out_shapes:
            if len(shape) >= min_rank:
                peak = max(peak, _shape_bytes(shape, rec.dtype))
    return peak


def report(records, k: int = 20) -> str:
    lines = ["== largest tensors (bytes x count) =="]
    for tot, b, c, op, s in top_tensors(records, k):
        lines.append(f"  {tot/2**30:8.3f} GiB  {c:4d}x {b/2**20:9.2f} MiB  "
                     f"{op:18s} {s}")
    lines.append("== bytes by opcode ==")
    for tot, c, op in opcode_bytes(records, k):
        lines.append(f"  {tot/2**30:8.3f} GiB  {c:5d} ops  {op}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun as dr
    res = dr.lower_cell(args.arch, args.shape, multi_pod=args.multipod,
                        verbose=False, keep_trace=True)
    if res.get("refused"):
        print("refused:", res["refused"])
        return
    print("peak GiB/dev:", res["memory"]["peak_per_device_GiB"])
    print(report(res["_trace"], args.top))


if __name__ == "__main__":
    main()
