"""The Eq. 13 suite on a mesh of ranks: every primitive, every
``LinearOp`` and its adjoint, and the memory operators, each held at the
reference's pin, and each collective's time.

    python -m repro_torch.launch.dist_check [--world N] [--device cuda|cpu]
                                            [--small]

Each check is (a) <F x, y> = <x, F* y> with the adjoint applied as an
operator and (b) ``torch.autograd`` through the hand-written backwards
(``linop.check_adjoint_pair``), on one global input drawn alike on every
rank and scattered by the check's specs; the collectives of unequal
blocks are checked (a) over a balanced split that leaves the last rank
an empty block (``empty_block_cases``; two ranks or more).  Shapes (``FULL``, the default):
glm4-9b's activation block (batch 4, seq 1024, d_model 4096) fp32, sharded
on seq for the gather, scatter, halo, shift and ring checks (seq-major,
seq first, for the ops that stack on dim 0); its FFN weight (4096, 13696)
for ``Repartition``; 64M-element buffers for the memory operators.
``SMALL`` cuts every extent for a quick run; its extents divide by up to 8
ranks.

The world is one process per rank (``mesh.spawn``): on ``cuda`` NCCL with
one rank per card, on ``cpu`` gloo.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from ..core import linop, memory as mem, partition, primitives as prim
from ..core.adjoint import adjoint_test, rel_err
from ..core.linop import P, check_adjoint, check_adjoint_pair
from . import mesh as mesh_mod

AX = "model"
FULL = {"act": (4, 1024, 4096), "ffn": (4096, 13696), "mem": 64 * 2 ** 20}
SMALL = {"act": (2, 64, 32), "ffn": (64, 96), "mem": 4096}
EPS = 1e-4        # the reference's Eq. 13 pin (tests/md)
MEM_EPS = 1e-5    # its pin for the memory operators (tests/test_memory_...)
HALO = (3, 1)     # (left, right) halo widths along seq


def op_cases(shapes: dict, k: int) -> list:
    """(name, op, global input shape) for every LinearOp class, at the
    suite's shapes over an axis of size ``k``."""
    B, S, D = shapes["act"]
    act, seq_major, ffn = (B, S, D), (S, B, D), shapes["ffn"]
    halos = partition.compute_halos(S, k, 5, padding=2)
    L = linop.Layout
    return [
        ("Identity", linop.Identity(), act),
        ("Broadcast", linop.Broadcast(AX), act),
        ("SumReduce", linop.SumReduce(AX), seq_major),
        ("AllReduce", linop.AllReduce(AX), seq_major),
        ("AllGather", linop.AllGather(AX, 1), act),
        ("ReduceScatter", linop.ReduceScatter(AX, 1), act),
        ("AllToAll", linop.AllToAll(AX, 2, 1), act),
        ("SendRecv", linop.SendRecv(AX, 1), seq_major),
        ("KVRingShift", linop.KVRingShift(AX, 1), seq_major),
        ("BatchScatter", linop.BatchScatter(AX, 1), act),
        ("GradSumReduce", linop.GradSumReduce(AX, 1), act),
        ("CapacityRestrict", linop.CapacityRestrict(1, S - S // 8, S), act),
        ("HaloExchange", linop.HaloExchange(AX, 1, *HALO), act),
        ("HaloAccumulate", linop.HaloAccumulate(AX, 1, *HALO),
         (B, S + k * sum(HALO), D)),
        ("HaloExchange unbalanced", linop.HaloExchange(
            AX, 1, left_widths=[h.left_halo for h in halos],
            right_widths=[h.right_halo for h in halos]), act),
        ("Repartition dim0->dim1", linop.Repartition(L(AX, 0), L(AX, 1)),
         ffn),
        ("Repartition replicated->dim1",
         linop.Repartition(L(None), L(AX, 1)), ffn),
        ("Repartition dim0->replicated",
         linop.Repartition(L(AX, 0), L(None)), ffn),
    ]


def prim_cases(shapes: dict) -> list:
    """(name, forward, adjoint, in spec, out spec, global shape) for the
    primitives no LinearOp wraps (the replicated pair), at the act shape."""
    act = shapes["act"]
    rep, seq = P(), P(None, AX, None)
    return [
        ("all_gather_replicated",
         lambda x: prim.all_gather_replicated(x, AX, 1),
         lambda y: prim.shard_slice_replicated(y, AX, 1), seq, rep, act),
        ("shard_slice_replicated",
         lambda x: prim.shard_slice_replicated(x, AX, 1),
         lambda y: prim.all_gather_replicated(y, AX, 1), rep, seq, act),
    ]


def empty_block_cases(shapes: dict, k: int, me: int) -> list:
    """(name, forward, this rank's input shape, output stacked over the
    axis) for the collectives of unequal blocks, over the balanced split
    of k - 1 along seq (and, for the all-to-all, of k - 1 along the
    feature dim): the last rank's block is empty, as a rank of a model
    axis larger than a head count holds no head."""
    B, _, D = shapes["act"]
    sizes = partition.balanced_split(k - 1, k)
    return [
        ("all_gather unequal, an empty block",
         lambda x: prim.all_gather(x, AX, 1, sizes), (B, sizes[me], D), True),
        ("reduce_scatter unequal, an empty block",
         lambda x: prim.reduce_scatter(x, AX, 1, sizes), (B, k - 1, D), True),
        ("all_to_all_v, an empty block",
         lambda x: prim.all_to_all_v(x, AX, 1, 2, sizes, sizes),
         (B, k - 1, sizes[me]), True),
        ("all_gather_replicated_v, an empty block",
         lambda x: prim.all_gather_replicated_v(x, AX, 1, sizes),
         (B, sizes[me], D), False),
    ]


def memory_cases(n: int, device) -> list:
    """(name, operator, its adjoint written with the memory operators) for
    every memory operator, on an ``n``-element buffer."""
    q = n // 4
    a, b = (0, q), (2 * q, 3 * q)
    idx = torch.randint(0, n, (q,), generator=torch.Generator().manual_seed(
        7)).to(device)   # take_linear: n/4 indices, repeats included
    return [
        ("allocate", lambda x: mem.allocate(x, q),
         lambda y: mem.deallocate(y, q)),
        ("deallocate", lambda x: mem.deallocate(x, q),
         lambda y: mem.allocate(y, q)),
        ("clear", lambda x: mem.clear(x, q, 2 * q),
         lambda y: mem.clear(y, q, 2 * q)),
        ("add", lambda x: mem.add(x, a, b), lambda y: mem.add(y, b, a)),
        ("copy_inplace", lambda x: mem.copy_inplace(x, a, b),
         lambda y: mem.clear(mem.add(y, b, a), *b)),
        ("copy_outofplace", lambda x: mem.copy_outofplace(x, a),
         lambda y: mem.deallocate(mem.add(y, (n, n + q), a), q)),
        ("move_inplace", lambda x: mem.move_inplace(x, a, b),
         lambda y: mem.move_inplace(y, b, a)),
        # [x[q:]; x[:q]]: the kept entries return to positions q.. of the
        # allocated buffer, then S_{b->a} and D_b
        ("move_outofplace", lambda x: mem.move_outofplace(x, a),
         lambda y: mem.deallocate(mem.add(torch.cat([y.new_zeros(q), y]),
                                          (n, n + q), a), q)),
        ("take_linear", lambda x: mem.take_linear(x, idx),
         lambda y: y.new_zeros(n).index_add_(0, idx, y)),
    ]


def _timer(device: torch.device):
    """ms of ``fn`` averaged over ``iters`` calls, after as many warm-up
    calls (so the caching allocator holds every buffer the timed calls
    allocate, NCCL's still in flight among them): CUDA events on a card,
    the host clock on the host."""
    def run(fn, iters):
        for _ in range(iters):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return run


def device_activity(fn, iters) -> dict:
    """The CUDA activity ``torch.profiler`` records over ``iters`` calls of
    ``fn``: device ms a call, summed over kernels and copies, and the three
    largest by name (us a call); ``{"error": ...}`` when it records none."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / iters)
                for e in prof.key_averages() if e.self_device_time_total]
    except (AssertionError, AttributeError, RuntimeError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    if not rows:
        return {"error": "the profiler recorded no device activity"}
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(us for _, us in rows) / 1e3,
            "top_us": dict(rows[:3])}


def suite(rank: int, mesh, *, shapes=FULL, time_iters: int = 20) -> dict:
    """Run every check on this rank of ``mesh`` (all ranks call it alike);
    returns the world, the backend, each check's relative error and pin,
    and each collective's time on this rank: ms by CUDA events around
    ``time_iters`` calls and, on a card, the device's own ms of kernels and
    copies in them by ``torch.profiler``."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    k = mesh.size(mesh.mesh_dim_names.index(AX))
    gen = torch.Generator(device=device)
    rel, eps, timing = {}, {}, []
    clock = _timer(device)

    def timed(name, fn, x):
        with torch.no_grad():
            out = fn(x)
            # input read once and output written once; a view moves nothing
            nbytes = (0 if out.data_ptr() == x.data_ptr() else
                      (x.numel() + out.numel()) * x.element_size())
            ms = clock(lambda: fn(x), time_iters)
            row = {"name": name, "world": k, "shape": list(x.shape),
                   "bytes": nbytes, "ms": ms, "gb_per_s": nbytes / ms / 1e6}
            if device.type == "cuda":   # the device's share of those ms
                row.update(device_activity(lambda: fn(x), time_iters))
        timing.append(row)

    with prim.use_mesh(mesh):
        for name, op, shape in op_cases(shapes, k):
            gen.manual_seed(0)
            r = check_adjoint(op, mesh, shape, generator=gen, eps=EPS,
                              device=device)
            rel[name], eps[name] = r.rel_err, EPS
            sizes = linop.axis_sizes(mesh)
            out_shape = op.space_map(linop.space_of(
                op.in_spec(len(shape)), shape, sizes), sizes).global_shape(
                    sizes)
            gen.manual_seed(1)
            r = check_adjoint(op.T, mesh, out_shape, generator=gen,
                              eps=EPS, device=device)
            rel[name + " .T"], eps[name + " .T"] = r.rel_err, EPS
            if not isinstance(op, (linop.Identity, linop.CapacityRestrict)):
                x = linop.scatter(torch.randn(shape, generator=gen,
                                              device=device),
                                  op.in_spec(len(shape)))
                timed(name, op, x)
        for name, fwd, adj, in_spec, out_spec, shape in prim_cases(shapes):
            gen.manual_seed(2)
            r = check_adjoint_pair(fwd, adj, mesh, in_spec, out_spec, shape,
                                   generator=gen, eps=EPS, name=name,
                                   device=device)
            rel[name], eps[name] = r.rel_err, EPS
            timed(name, fwd, linop.scatter(
                torch.randn(shape, generator=gen, device=device), in_spec))
        if k > 1:   # one rank has no unequal block to leave empty
            group = linop.spec_groups(P(AX), mesh)
            for name, fwd, shape, stacked in empty_block_cases(
                    shapes, k, prim.axis_index(AX)):
                gen.manual_seed(4)
                x = torch.randn(shape, generator=gen, device=device)
                r = adjoint_test(fwd, x, eps=EPS, name=name, x_groups=group,
                                 y_groups=group if stacked else [])
                rel[name], eps[name] = r.rel_err, EPS
    n = shapes["mem"]
    for name, f, adj in memory_cases(n, device):
        gen.manual_seed(3)
        x = torch.randn(n, generator=gen, device=device)
        r = adjoint_test(f, x, generator=gen, eps=MEM_EPS, name=name)
        with torch.no_grad():
            fx = f(x.clone())
            y = torch.randn(fx.shape, generator=gen, device=device)
            pair = rel_err(fx, y, x, adj(y.clone()))
        rel["memory " + name] = max(r.rel_err, pair)
        eps["memory " + name] = MEM_EPS
        del x, fx, y
    return {"world": k, "backend": torch.distributed.get_backend(),
            "device": str(device), "rel_err": rel, "eps": eps,
            "failed": sorted(c for c in rel if not rel[c] < eps[c]),
            "timing": timing}


def run(rank, mesh, shapes=FULL):
    """``suite`` as ``mesh.spawn`` calls it (a module-level function)."""
    return suite(rank, mesh, shapes=shapes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the card count on cuda, 2 on cpu)")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 2)
    res = mesh_mod.spawn(functools.partial(
        run, shapes=SMALL if args.small else FULL), world,
        device=args.device, timeout_s=600)[0]
    print(json.dumps({"dist": res}))
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
