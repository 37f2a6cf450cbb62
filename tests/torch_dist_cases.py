"""Cases shared by the port's distributed parity tests and the JAX child
that computes the reference's side of them (``torch_dist_jax.py``).

Imports numpy only: the torch ranks and the JAX child both import this
module, and neither may load the other's framework.  Each case names a
mesh, its inputs (numpy, drawn from a seed), the boundary specs as tuples
of axis names, and a body written once against either package's
``primitives`` module ``p`` and axis-index function ``idx``.

Each side evaluates a case on the global arrays: the forward, the
vector-Jacobian product for a cotangent drawn here, and Eq. 13.  The
torch side runs the body per rank in the explicit-copy cotangent
convention (``repro_torch/core/primitives.py``); the JAX side lifts it
with ``shard_map``.  The global results must agree.
"""

from __future__ import annotations

import random
import zlib

import numpy as np

AX = "model"
EPS = 1e-4            # the reference's Eq. 13 pin (tests/md)
FWD_RTOL = 1e-6       # forward parity where a sum's order may differ
GRAD_TOL = 1e-5       # gradient parity
MESHES = {
    "1d": ((8,), ("model",)),
    "2d": ((2, 4), ("data", "model")),
    "3d": ((2, 2, 2), ("data", "pipe", "model")),
    # the fuzzer's meshes (tests/md/test_adjoint_property.py:_axis_choices)
    "ax0": ((8,), ("ax0",)),
    "d0d1": ((2, 4), ("d0", "d1")),
    "4d": ((2, 1, 2, 2), ("data", "pipe", "ctx", "model")),
    "5d": ((2, 1, 1, 2, 2), ("data", "pipe", "ctx", "model", "ep")),
}


def seed_of(case_id: str) -> int:
    """A seed for a case, from its id (the same in both packages)."""
    return zlib.crc32(case_id.encode()) % (2 ** 31)


def draw(shape, seed: int) -> np.ndarray:
    """Standard normal float32 draws of ``shape`` from ``seed``."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Primitives: the cases of tests/md/test_primitive_adjoints.py.
#
# case keys: mesh; inputs (arrays); specs (one per input); out (spec);
# lin (the input the body is linear in, for Eq. 13 and the vjp); body(p,
# idx, torch) -> fn(*inputs); exact (forward is pure data movement);
# optional y (the cotangent), torch_out and torch_y (the port's typing of
# an output whose JAX spec has no single-space reading, and the cotangent
# that makes its vjp the JAX one).
# ---------------------------------------------------------------------------

def _pair_body(p, idx, torch):
    def body(x):
        r = p.sum_reduce(x, AX)
        return p.broadcast(r, AX) * (idx(AX) + 1.0)
    return body


def _boundary_body(p, idx, torch):
    # JAX: shard_map's transpose of the replicated in_spec is the paper's
    # B*.  Per rank the broadcast is explicit, and its backward sums.
    if torch:
        return lambda xx, w: xx * p.broadcast(w, AX)
    return lambda xx, w: xx * w


def _gather_body(p, idx, torch):
    return lambda x: p.all_gather(x, AX, 0) * (idx(AX) + 1.0)


def _compose_2d_body(p, idx, torch):
    def body(x):
        return p.sum_reduce(p.broadcast(x, "data"), "model")
    return body


def _one(fn):
    return lambda p, idx, torch: (lambda x: fn(p, x))


def prim_cases() -> dict:
    cases = {
        "broadcast_sum_reduce_pair": dict(
            mesh="1d", inputs=[draw((16, 5), 0)], specs=[(AX,)], out=(AX,),
            body=_pair_body, exact=False),
        "boundary_transpose": dict(
            mesh="1d", inputs=[draw((16,), 1), draw((2,), 9)],
            specs=[(AX,), ()], out=(AX,), lin=1, body=_boundary_body,
            exact=True),
        "sum_reduce": dict(
            mesh="1d", inputs=[draw((16, 3), 2)], specs=[(AX,)], out=(),
            body=_one(lambda p, x: p.sum_reduce(x, AX)), exact=False),
        "all_reduce": dict(
            mesh="1d", inputs=[draw((8, 4), 3)], specs=[(AX,)], out=(AX,),
            body=_one(lambda p, x: p.all_reduce(x, AX)), exact=False),
        "all_gather": dict(
            mesh="1d", inputs=[draw((16, 3), 4)], specs=[(AX,)], out=(AX,),
            body=_gather_body, exact=True),
        "reduce_scatter": dict(
            mesh="1d", inputs=[draw((16, 40), 5)], specs=[(None, AX)],
            out=(AX, None),
            body=_one(lambda p, x: p.reduce_scatter(x, AX, 0)), exact=False),
        "all_to_all": dict(
            mesh="1d", inputs=[draw((8, 8, 4), 6)], specs=[(AX, None)],
            out=(None, AX),
            body=_one(lambda p, x: p.all_to_all(x, AX, 1, 0)), exact=True),
        "send_recv": dict(
            mesh="1d", inputs=[draw((16, 2), 7)], specs=[(AX,)], out=(AX,),
            body=_one(lambda p, x: p.send_recv(x, AX, 1)), exact=True),
        "halo_forward_semantics": dict(
            mesh="1d", inputs=[np.arange(32, dtype=np.float32)],
            specs=[(AX,)], out=(AX,),
            body=_one(lambda p, x: p.halo_exchange(x, AX, 0, 2, 1)),
            exact=True),
        "halo_adds_into_bulk": dict(
            mesh="1d", inputs=[np.zeros(16, np.float32)], specs=[(AX,)],
            out=(AX,), y=np.ones(32, np.float32),
            body=_one(lambda p, x: p.halo_exchange(x, AX, 0, 1, 1)),
            exact=True),
        "halo_unbalanced": dict(
            mesh="1d", inputs=[draw((32, 2), 8)], specs=[(AX,)], out=(AX,),
            body=_one(lambda p, x: p.halo_exchange_unbalanced(
                x, AX, 0, UNBAL_LW, UNBAL_RW)), exact=True),
        "halo_unbalanced_ones": dict(
            mesh="1d", inputs=[np.ones((32, 2), np.float32)], specs=[(AX,)],
            out=(AX,), body=_one(lambda p, x: p.halo_exchange_unbalanced(
                x, AX, 0, UNBAL_LW, UNBAL_RW)), exact=True),
        # broadcast over one axis, sum-reduce over the other (conv pattern).
        # JAX declares the output replicated over both axes; per rank it is
        # stacked over "data" (two equal copies after B), so the port's
        # output spec says so, and its cotangent [y; 0] makes the port's
        # global vjp the JAX one.
        "compose_2d": dict(
            mesh="2d", inputs=[draw((4, 8), 10)], specs=[(None, AX)],
            out=(None, None), torch_out=("data", None), y=draw((4, 2), 11),
            torch_y=lambda y: np.concatenate([y, np.zeros_like(y)]),
            body=_compose_2d_body, exact=False),
    }
    for left, right in HALO_WIDTHS:
        cases[f"halo_{left}_{right}"] = dict(
            mesh="1d", inputs=[draw((32, 3), 20 + 3 * left + right)],
            specs=[(AX,)], out=(AX,),
            body=_one(lambda p, x, l=left, r=right: p.halo_exchange(
                x, AX, 0, l, r)), exact=True)
    for i, case in enumerate(cases.values()):
        case.setdefault("lin", 0)
        case.setdefault("seed", 100 + i)
    return cases


HALO_WIDTHS = [(1, 0), (0, 2), (2, 3)]
UNBAL_LW = (0, 1, 2, 0, 1, 2, 0, 1)
UNBAL_RW = (1, 0, 2, 1, 0, 2, 1, 0)


# Every primitive along every axis of the 2-D and 3-D meshes: (name, body,
# spec of x at global shape SWEEP_SHAPE, out spec, exact).  The unbalanced
# widths depend on the axis size.
SWEEP_SHAPE = (8, 16, 3)
REPLICATED_PAIR = ("all_gather_replicated", "shard_slice_replicated")


def _sweep_prims(ax, k):
    lw = tuple((i % 3) for i in range(k))
    rw = tuple(((i + 1) % 3) for i in range(k))
    s0, s1, rep = (ax, None, None), (None, ax, None), ()
    return [
        ("broadcast", lambda p, x, t: p.broadcast(x, ax), rep, s0, True),
        ("sum_reduce", lambda p, x, t: p.sum_reduce(x, ax), s0, rep, False),
        ("all_reduce", lambda p, x, t: p.all_reduce(x, ax), s0, s0, False),
        ("all_gather", lambda p, x, t: p.all_gather(x, ax, 1), s1, s1, True),
        # JAX's replicated pair assumes the replicated cotangent that only a
        # hand-scheduled backward supplies (DESIGN §4); under shard_map's
        # lift its vjp is not the global adjoint (Eq. 13 fails there).  The
        # port's pair IS grad_sum_reduce / batch_scatter, so those are its
        # JAX references, and the forwards are the same.  ``t == "own"``
        # runs JAX's own pair, to record that failure.
        ("all_gather_replicated",
         lambda p, x, t: (p.all_gather_replicated if t
                          else p.grad_sum_reduce)(x, ax, 1), s1, rep, True),
        ("shard_slice_replicated",
         lambda p, x, t: (p.shard_slice_replicated if t
                          else p.batch_scatter)(x, ax, 1), rep, s1, True),
        ("reduce_scatter", lambda p, x, t: p.reduce_scatter(x, ax, 1), s1, s1,
         False),
        ("all_to_all", lambda p, x, t: p.all_to_all(x, ax, 1, 0), s0, s1,
         True),
        ("send_recv", lambda p, x, t: p.send_recv(x, ax, 1), s0, s0, True),
        ("ring_shift", lambda p, x, t: p.ring_shift(x, ax, -1), s0, s0, True),
        ("batch_scatter", lambda p, x, t: p.batch_scatter(x, ax, 1), rep, s1,
         True),
        ("grad_sum_reduce", lambda p, x, t: p.grad_sum_reduce(x, ax, 1), s1,
         rep, True),
        ("halo_exchange", lambda p, x, t: p.halo_exchange(x, ax, 1, 2, 1), s1,
         s1, True),
        ("halo_accumulate", lambda p, x, t: p.halo_accumulate(x, ax, 1, 1, 1),
         s1, s1, False),
        ("halo_exchange_unbalanced",
         lambda p, x, t: p.halo_exchange_unbalanced(x, ax, 1, lw, rw), s1, s1,
         True),
    ]


def sweep_cases() -> dict:
    """``{case id: (mesh, x, x spec, out spec, exact, seed)}`` and the
    bodies by id, for every primitive along every axis of the 2-D and 3-D
    meshes."""
    cases = {}
    seed = 1000
    for mesh in ("2d", "3d"):
        shape, axes = MESHES[mesh]
        for ax, k in zip(axes, shape):
            for name, fn, xs, os_, exact in _sweep_prims(ax, k):
                seed += 1
                cases[f"{name}-{mesh}-{ax}"] = dict(
                    mesh=mesh, inputs=[draw(SWEEP_SHAPE, seed)], specs=[xs],
                    out=os_, lin=0, seed=seed + 5000, exact=exact,
                    own=name in REPLICATED_PAIR,
                    body=(lambda f: lambda p, idx, torch: (
                        lambda x: f(p, x, torch)))(fn))
    return cases


# ---------------------------------------------------------------------------
# The operator algebra: the cases of tests/md/test_linop.py, written once
# against either package's ``linop`` module L.
# ---------------------------------------------------------------------------

def concrete_ops(L, AX=AX, k=8):
    """tests/md/test_linop.py:CONCRETE_OPS over axis ``AX`` of size ``k``
    (the unbalanced widths cut to k workers)."""
    lw, rw = UNBAL_LW[:k], UNBAL_RW[:k]
    return [
        (L.Identity(), (16, 3)),
        (L.Broadcast(AX), (4, 3)),
        (L.SumReduce(AX), (16, 3)),
        (L.AllReduce(AX), (16, 3)),
        (L.AllGather(AX, 0), (16, 3)),
        (L.ReduceScatter(AX, 0), (128, 3)),
        (L.AllToAll(AX, 1, 0), (8, 8, 4)),
        (L.SendRecv(AX, 1), (16, 2)),
        (L.SendRecv(AX, -2), (16, 2)),
        (L.KVRingShift(AX, 1), (16, 2)),
        (L.KVRingShift(AX, -3), (16, 2)),
        (L.BatchScatter(AX, 0), (16, 3)),
        (L.BatchScatter(AX, 1), (3, 16)),
        (L.GradSumReduce(AX, 0), (16, 3)),
        (L.GradSumReduce(AX, 1), (3, 16)),
        (L.CapacityRestrict(0, 12, 16), (16, 3)),
        (L.CapacityRestrict(1, 2, 4, embed=True), (3, 2)),
        (L.HaloExchange(AX, 0, 2, 1), (32, 3)),
        (L.HaloAccumulate(AX, 0, 2, 1), (56, 3)),
        (L.HaloExchange(AX, 0, left_widths=lw, right_widths=rw), (32, 2)),
        (L.Repartition(L.Layout(None), L.Layout(AX, 0)), (16, 3)),
        (L.Repartition(L.Layout(AX, 1), L.Layout(None)), (3, 16)),
        (L.Repartition(L.Layout(AX, 0), L.Layout(AX, 1)), (8, 8)),
        (L.Repartition(L.Layout(AX, 0), L.Layout(AX, 0)), (16, 3)),
    ]


def op_sweep(L) -> dict:
    """``{case id: (mesh, op, global input shape)}``: every concrete op along
    every axis of the (2, 4) and (2, 2, 2) meshes."""
    cases = {}
    for mesh in ("2d", "3d"):
        shape, axes = MESHES[mesh]
        for ax, k in zip(axes, shape):
            for op, gshape in concrete_ops(L, ax, k):
                cases[f"{op!r}-{mesh}-{ax}"] = (mesh, op, gshape)
    return cases


def composites(L):
    return [
        (L.HaloExchange(AX, 0, 1, 1) @ L.SendRecv(AX, 1)
         @ L.AllGather(AX, 0), (16, 3)),
        (L.Broadcast(AX) @ L.SumReduce(AX), (16, 3)),
        (L.ReduceScatter(AX, 0) @ L.SendRecv(AX, -1)
         @ L.AllGather(AX, 0), (16, 3)),
        (L.HaloExchange(AX, 0, 2, 1).T @ L.HaloExchange(AX, 0, 2, 1),
         (32, 3)),
        (L.AllReduce(AX) @ L.HaloExchange(
            AX, 0, left_widths=(0, 1, 1, 0, 1, 1, 0, 1),
            right_widths=(1, 1, 0, 1, 1, 0, 1, 0)), (32, 2)),
        (L.GradSumReduce(AX, 1) @ L.BatchScatter(AX, 1), (4, 16)),
        (L.KVRingShift(AX, -1) @ L.KVRingShift(AX, 1), (16, 3)),
        (L.AllGather(AX, 0) @ L.KVRingShift(AX, 1), (16, 4)),
        (L.AllToAll(AX, 1, 0) @ L.AllToAll(AX, 0, 1)
         @ L.CapacityRestrict(0, 8, 9) @ L.BatchScatter(AX, 1), (9, 64)),
        (L.Repartition(L.Layout(AX, 1), L.Layout(AX, 0))
         @ L.Repartition(L.Layout(AX, 0), L.Layout(AX, 1)), (8, 8)),
        (L.Repartition(L.Layout(None), L.Layout(AX, 1))
         @ L.Repartition(L.Layout(AX, 0), L.Layout(None)), (8, 8)),
    ]


def random_chain(L, seed: int, local0: int = 4):
    """tests/md/test_linop.py:_random_chain: a block-wise chain from
    ``random.Random(seed)`` (all ops on dim 0)."""
    rng = random.Random(seed)
    n_ops = rng.randint(3, 5)
    ops, local = [], local0
    for _ in range(n_ops):
        kind = rng.choice(["send", "allreduce", "halo", "gather"])
        if kind == "send":
            ops.append(L.SendRecv(AX, rng.choice([-2, -1, 1, 2])))
        elif kind == "allreduce":
            ops.append(L.AllReduce(AX))
        elif kind == "halo":
            left, right = rng.randint(0, 2), rng.randint(0, 2)
            ops.append(L.HaloExchange(AX, 0, left, right))
            local += left + right
        else:
            ops.append(L.AllGather(AX, 0))
            local *= 8
        if local > 512:
            break
    chain = ops[0]
    for op in ops[1:]:
        chain = op @ chain
    return chain


RANDOM_SEEDS = range(5)


def appb_op(L, compute_halos):
    specs = compute_halos(32, 8, 5, padding=2)
    return L.HaloExchange(AX, 0, left_widths=[s.left_halo for s in specs],
                          right_widths=[s.right_halo for s in specs])


def cross_axis_op(L):
    return L.Repartition(L.Layout("data", 0), L.Layout("model", 1))


def linop_cases(L, compute_halos) -> dict:
    """``{case id: (mesh, op, global input shape)}``; each op's adjoint is
    a case of its own (``<id>.T``) with the op's output shape."""
    cases = {}
    for op, shape in concrete_ops(L):
        cases[f"op:{op!r}"] = ("1d", op, shape)
    for i, (op, shape) in enumerate(composites(L)):
        cases[f"chain{i}"] = ("1d", op, shape)
    for seed in RANDOM_SEEDS:
        cases[f"random_chain_{seed}"] = ("1d", random_chain(L, seed),
                                         (32, 2))
    cases["halo_appB"] = ("1d", appb_op(L, compute_halos), (32, 2))
    cases["cross_axis"] = ("2d", cross_axis_op(L), (8, 8))
    return cases


# ---------------------------------------------------------------------------
# Fuzzer chains (tests/md/test_adjoint_property.py), carried between the
# packages as plain descriptions of their ops.
# ---------------------------------------------------------------------------

FUZZ_CHOICES = [("ax0", "ax0"), ("d0d1", "d0"), ("d0d1", "d1"),
                ("3d", "data"), ("3d", "pipe"), ("3d", "model"),
                ("4d", "ctx"), ("4d", "model"), ("5d", "ep"), ("5d", "data")]


def describe(op):
    """A JSON-able description of a LinearOp (or Layout): its class name
    and fields."""
    import dataclasses
    fields = {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if dataclasses.is_dataclass(v):
            v = describe(v)
        elif isinstance(v, tuple):
            v = ([describe(o) for o in v] if v and dataclasses.is_dataclass(
                v[0]) else list(v))
        fields[f.name] = v
    return {"cls": type(op).__name__, "fields": fields}


def build(L, desc):
    """The op ``desc`` describes, from linop module ``L``."""
    fields = {}
    for name, v in desc["fields"].items():
        if isinstance(v, dict):
            v = build(L, v)
        elif isinstance(v, list):
            v = tuple(build(L, o) if isinstance(o, dict) else o for o in v)
        fields[name] = v
    return getattr(L, desc["cls"])(**fields)


def chain_of(L, descs):
    """Compose ops given in APPLICATION order (first applied first)."""
    ops = [build(L, d) for d in descs]
    chain = ops[0]
    for op in ops[1:]:
        chain = op @ chain
    return chain


# ---------------------------------------------------------------------------
# The JAX child.
# ---------------------------------------------------------------------------

JAX_TIMEOUT_S = 900


def start_jax(which: str, out_path, *extra):
    """Start ``torch_dist_jax.py`` on 8 host devices in a child
    interpreter (the main pytest process must see one device)."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_dist_jax.py"), which,
         str(out_path), *map(str, extra)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_jax(proc, out_path) -> dict:
    """Wait for the child (killing it past ``JAX_TIMEOUT_S``) and load its
    results."""
    try:
        _, err = proc.communicate(timeout=JAX_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"JAX child failed ({proc.returncode}):\n"
                           f"{err[-4000:]}")
    with np.load(out_path) as data:
        return dict(data)
