"""Cases shared by the port's region-layer parity tests and the JAX child
that computes the reference's side of them (``torch_region_jax.py``).

Imports numpy only: the torch ranks and the JAX child both import this
module, and neither may load the other's framework.  A case body is
written once against a namespace ``ns`` holding either package's ``L``
(``core/layers``), ``overlap``, ``dist_jit``, ``Partitioned``, ``Policy``
and ``P`` (its PartitionSpec), and a mesh of that package.  Each side
evaluates a case on the global arrays: the forward, and the gradient of
``sum(y ** 2)`` (the reference tests' loss) for the case's float inputs.
The cases are those of tests/md/test_layers_md.py, tests/md/test_overlap.py
and the region cases of tests/md/test_dist_jit.py, at those files' pins.
"""

from __future__ import annotations

import json

import numpy as np

MESHES = {
    "2d": ((2, 4), ("data", "model")),
    "1d": ((8,), ("model",)),
    "cihw": ((2, 2, 2), ("ci", "h", "w")),
    "hw": ((2, 4), ("h", "w")),
    "s": ((8,), ("s",)),
    "fofi": ((2, 2), ("fo", "fi")),
    "tp2": ((2, 2), ("data", "model")),
}
# the meshes whose policies are compared (tests/torch_dist_cases.py:MESHES)
POLICY_MESHES = {
    "1d": ((8,), ("model",)),
    "2d": ((2, 4), ("data", "model")),
    "3d": ((2, 2, 2), ("data", "pipe", "model")),
    "ax0": ((8,), ("ax0",)),
    "d0d1": ((2, 4), ("d0", "d1")),
    "4d": ((2, 1, 2, 2), ("data", "pipe", "ctx", "model")),
    "5d": ((2, 1, 1, 2, 2), ("data", "pipe", "ctx", "model", "ep")),
}


def draw(shape, seed: int) -> np.ndarray:
    """Standard normal float32 draws of ``shape`` from ``seed``."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Layer, ring and region cases.  Keys: mesh; inputs (numpy); body(ns,
# mesh) -> fn(*inputs) -> y; grads (indices of the inputs to differentiate);
# fwd / grad (the reference file's pins: assert_allclose rtol = atol).
# ---------------------------------------------------------------------------

def _affine_new_api(ns, mesh):
    return ns.dist_jit(
        lambda x, w, b: ns.L.affine(x, w, b, fo_axis="data",
                                    fi_axis="model"),
        ns.Policy.for_mesh(mesh),
        (ns.Partitioned(None, "model"), ns.Partitioned("data", "model"),
         ns.Partitioned("data")),
        ns.Partitioned(None, "data"))


def _ring(kind):
    def body(ns, mesh):
        if kind == "gather":
            fn, w_part = ns.overlap.ring_allgather_matmul, ns.P(None, "model")
        else:
            fn, w_part = (ns.overlap.ring_matmul_reducescatter,
                          ns.P("model", None))
        return ns.dist_jit(lambda x, w: fn(x, w, "model"),
                           ns.Policy.for_mesh(mesh),
                           (ns.P(None, "model"), w_part), ns.P(None, "model"))
    return body


def _affine_tp(explicit_tp):
    def body(ns, mesh):
        return ns.dist_jit(
            lambda x, w: ns.L.affine(x, w, None, fo_axis=None,
                                     fi_axis="model"),
            ns.Policy.for_mesh(mesh, explicit_tp=explicit_tp),
            (ns.Partitioned(None, "model"), ns.Partitioned(None, "model")),
            ns.Partitioned(None, None))
    return body


def _gather_scatter(kind, explicit_tp):
    def body(ns, mesh):
        if kind == "gather":
            layer, w_part = ns.L.affine_gather, ns.Partitioned(None, "model")
        else:
            layer, w_part = ns.L.affine_scatter, ns.Partitioned("model", None)
        return ns.dist_jit(lambda x, w: layer(x, w, axis="model"),
                           ns.Policy.for_mesh(mesh, explicit_tp=explicit_tp),
                           (ns.Partitioned(None, "model"), w_part),
                           ns.Partitioned(None, "model"))
    return body


def _pool(op, spatial, k=2, stride=2):
    return lambda ns, mesh: (lambda x: ns.L.dist_pool(
        mesh, x, k=k, stride=stride, op=op, spatial_axes=spatial))


def layer_cases() -> dict:
    r = draw
    cases = {
        # tests/md/test_layers_md.py::TestDistAffine
        "affine_new_api": dict(
            mesh="2d", inputs=[r((6, 16), 0), r((8, 16), 1), r((8,), 2)],
            body=_affine_new_api, grads=(0, 1, 2), fwd=2e-5, grad=1e-4),
        "affine_2d_bias": dict(
            mesh="2d", inputs=[r((6, 16), 3), r((8, 16), 4), r((8,), 5)],
            body=lambda ns, mesh: (lambda x, w, b: ns.L.dist_affine(
                mesh, x, w, b, fo_axis="data", fi_axis="model")),
            grads=(0, 1, 2), fwd=2e-5, grad=1e-4),
        "affine_2d_nobias": dict(
            mesh="2d", inputs=[r((6, 16), 7), r((8, 16), 6)],
            body=lambda ns, mesh: (lambda x, w: ns.L.dist_affine(
                mesh, x, w, None, fo_axis="data", fi_axis="model")),
            grads=(0, 1), fwd=2e-5, grad=1e-4),
        "affine_fo_only": dict(
            mesh="2d", inputs=[r((8, 12), 8), r((16, 12), 9)],
            body=lambda ns, mesh: (lambda x, w: ns.L.dist_affine(
                mesh, x, w, None, fo_axis="model", fi_axis=None,
                batch_axis="data")),
            grads=(0, 1), fwd=2e-5, grad=1e-4),
        # TestDistConv
        "conv2d_ci_h_w": dict(
            mesh="cihw",
            inputs=[r((2, 4, 8, 8), 10), r((6, 4, 3, 3), 11), r((6,), 12)],
            body=lambda ns, mesh: (lambda x, w, b: ns.L.dist_conv_same(
                mesh, x, w, b, spatial_axes=("h", "w"), batch_axis=None,
                co_axis=None, ci_axis="ci")),
            grads=(0, 1, 2), fwd=2e-4, grad=1e-3),
        "conv2d_h_w": dict(
            mesh="hw", inputs=[r((2, 3, 8, 8), 13), r((5, 3, 3, 3), 14)],
            body=lambda ns, mesh: (lambda x, w: ns.L.dist_conv_same(
                mesh, x, w, None, spatial_axes=("h", "w"))),
            grads=(0, 1), fwd=2e-4, grad=1e-3),
        "conv1d_causal": dict(
            mesh="1d", inputs=[r((2, 32, 6), 15), r((4, 6), 16)],
            body=lambda ns, mesh: (lambda x, w: ns.L.dist_conv1d_causal(
                mesh, x, w, seq_axis="model", batch_axis=None)),
            grads=(0, 1), fwd=2e-5, grad=1e-4),
        # TestDistPool
        "pool_max": dict(mesh="hw", inputs=[r((2, 3, 8, 16), 19)],
                         body=_pool("max", ("h", "w")), grads=(0,),
                         fwd=2e-5, grad=1e-4),
        "pool_avg": dict(mesh="hw", inputs=[r((2, 3, 8, 16), 19)],
                         body=_pool("avg", ("h", "w")), grads=(0,),
                         fwd=2e-5, grad=1e-4),
        # forward only: the reference's reduce_window max has no reverse
        # rule inside shard_map (repro/core/layers.py:376-379)
        "pool_overlapping": dict(
            mesh="s", inputs=[r((1, 1, 32), 20)],
            body=_pool("max", ("s",), k=3, stride=1), grads=(),
            fwd=2e-5, grad=1e-4),
        # a mesh axis the body never touches: "w" is in no spec, so every
        # rank along it computes the same thing (the grads must not be 4x)
        "pool_max_unused_axis": dict(
            mesh="hw", inputs=[r((2, 3, 8, 16), 21)],
            body=_pool("max", ("h", None)), grads=(0,), fwd=2e-5,
            grad=1e-4),
        "pool_avg_unused_axis": dict(
            mesh="hw", inputs=[r((2, 3, 8, 16), 22)],
            body=_pool("avg", ("h", None)), grads=(0,), fwd=2e-5,
            grad=1e-4),
        # TestDistEmbedding
        "embedding": dict(
            mesh="1d",
            inputs=[np.random.default_rng(24).integers(0, 64, (32,))
                    .astype(np.int32), r((64, 16), 23)],
            body=lambda ns, mesh: (lambda ids, t: ns.L.dist_embedding(
                mesh, ids, t, vocab_axis="model", batch_axis=None)),
            grads=(1,), fwd=1e-6, grad=1e-4),
        # tests/md/test_overlap.py
        "ring_allgather_matmul": dict(
            mesh="1d", inputs=[r((4, 32), 30), r((32, 24), 31)],
            body=_ring("gather"), grads=(0, 1), fwd=2e-5, grad=1e-4),
        "ring_matmul_reducescatter": dict(
            mesh="1d", inputs=[r((4, 32), 32), r((32, 24), 33)],
            body=_ring("scatter"), grads=(0, 1), fwd=2e-5, grad=1e-4),
    }
    # tests/md/test_dist_jit.py::TestDistAffineThroughDistJit
    for etp in (False, True):
        cases[f"affine_through_dist_jit_tp{int(etp)}"] = dict(
            mesh="1d", inputs=[r((6, 16), 40), r((8, 16), 41)],
            body=_affine_tp(etp), grads=(0, 1), fwd=2e-5, grad=1e-4)
        # TestGatherScatterAffines
        for kind in ("gather", "scatter"):
            cases[f"affine_{kind}_tp{int(etp)}"] = dict(
                mesh="1d", inputs=[r((4, 32), 42), r((32, 24), 43)],
                body=_gather_scatter(kind, etp), grads=(0, 1), fwd=2e-5,
                grad=1e-4)
    return cases


# ---------------------------------------------------------------------------
# Spec and policy resolution (tests/md/test_dist_jit.py:128-141 and the
# Policy of repro/sharding/policy.py), as JSON-able facts.
# ---------------------------------------------------------------------------

LOGICAL = ["batch", "data", "seq", "ctx", "heads", "ff", "experts", "ep",
           "vocab", "fsdp", "kvdim", "kvseq", "model", "pipe", "stage",
           None, "none", ("batch", "model"), ("pipe", "heads"), "nonsense"]
PROPERTIES = ["active_data_axis", "active_ctx_axis", "active_ep_axis",
              "ctx_size", "ep_size", "model_size", "pipe_size", "dp_size"]
PARAMS = [("blocks/pos0/attn/wq", (2, 64, 64)),
          ("blocks/pos0/attn/wo", (2, 64, 64)),
          ("blocks/pos0/mlp/w_down", (2, 128, 64)),
          ("blocks/pos0/moe/we_up", (2, 8, 64, 32)),
          ("blocks/pos0/ssm/conv_w", (2, 4, 6)),
          ("blocks/pos0/ssm/a_log", (2, 3)),
          ("embed", (64, 32)), ("lm_head", (32, 64)),
          ("norm_final", (32,)), ("unknown_leaf", (4, 4))]


def _norm(v):
    """Specs and axis tuples as JSON lists."""
    if isinstance(v, tuple):
        return [_norm(e) for e in v]
    return v


def _spec(s):
    return [_norm(e) for e in s]


def _try(fn):
    try:
        return fn()
    except (ValueError, KeyError) as e:
        return f"error {type(e).__name__}" if isinstance(e, ValueError) \
            else "error"


def _facts(ns, pol, axes, with_params):
    rec = {}
    for name in LOGICAL + list(axes):
        rec[f"resolve {name}"] = _try(lambda n=name: _norm(
            pol.resolve_axis(n)))
    rec["spec batch seq heads"] = _try(lambda: _spec(
        pol.spec("batch", "seq", "heads")))
    for prop in PROPERTIES:
        rec[prop] = _try(lambda p=prop: getattr(pol, p))
    if with_params:
        for path, shape in PARAMS:
            rec[f"param {path}"] = _try(lambda p=path, s=shape: _spec(
                pol.param_spec(p, s)))
    bound = pol.bind(fi=axes[-1], fo=axes[0], rep=None)
    rec["bind fo fi"] = _spec(ns.Partitioned("fo", "fi").resolve(bound))
    rec["bind rep"] = _spec(ns.Partitioned("rep").resolve(bound))
    rec["bind batch None heads"] = _try(lambda: _spec(
        ns.Partitioned("batch", None, "heads").resolve(bound)))
    rec["replicated"] = _spec(ns.Partitioned().resolve(pol))
    return rec


def policy_facts(ns, mesh, axes) -> str:
    """Every resolution fact of three policies over ``mesh``, as JSON."""
    pols = {"for_mesh": (ns.Policy.for_mesh(mesh), True),
            "for_mesh fsdp seq_shard": (
                ns.Policy.for_mesh(mesh, fsdp=True, seq_shard=True), True),
            "default": (ns.Policy(mesh), False)}
    out = {name: _facts(ns, pol, axes, params)
           for name, (pol, params) in pols.items()}
    return json.dumps(out, sort_keys=True)


def boundary_errors(ns, mesh) -> str:
    """What dist_jit says of an ill-typed boundary on a ("data", "model")
    mesh: a spec naming an absent axis, and an axis on two dims."""
    out = {}
    pol = ns.Policy.for_mesh(mesh)
    for name, parts in {"absent axis": (ns.P(None, "zz"),),
                        "axis twice": (ns.Partitioned("data", "data"),)}.items():
        try:
            ns.dist_jit(lambda x: x, pol, parts, ns.Partitioned())
            out[name] = "accepted"
        except Exception as e:   # noqa: BLE001 — the type is the fact
            msg = str(e)
            out[name] = [type(e).__name__, "names mesh axis 'zz'" in msg,
                         "over two tensor dims" in msg]
    return json.dumps(out, sort_keys=True)


# ---------------------------------------------------------------------------
# Models: LeNet-5 on 2x2 (tests/md/test_lenet_md.py) and the explicit-TP
# sublayer (tests/md/test_dist_jit.py::TestFusedTransformerSublayer).
# ---------------------------------------------------------------------------

LENET_FWD, LENET_GRAD, LENET_LOSS = 2e-4, 2e-3, 1e-3
LENET_STEPS, LENET_LR = 5, 0.05
TP_FWD, TP_GRAD = 2e-4, 5e-4
TP_CFG = dict(name="tp_test", family="dense", num_layers=1, d_model=64,
              num_heads=8, num_kv_heads=4, head_dim=8, d_ff=128,
              vocab_size=64, dtype="float32", remat=False, attn_chunk=16)
TP_MESHES = {"tp4": "2d", "tp2": "tp2"}   # (data, model) = (2, 4), (2, 2)


def tp_inputs():
    x = draw((2, 16, 64), 8)
    positions = np.broadcast_to(np.arange(16)[None, :], (2, 16)).astype(
        np.int32).copy()
    return x, positions


# ---------------------------------------------------------------------------
# The JAX child.
# ---------------------------------------------------------------------------

JAX_TIMEOUT_S = 900


def start_jax(which: str, out_path):
    """Start ``torch_region_jax.py`` on 8 host devices in a child
    interpreter (the main pytest process must see one device)."""
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.join(here, "torch_region_jax.py"), which,
         str(out_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def params_path(out_path) -> str:
    """Where the JAX child writes the reference's parameters first."""
    return f"{out_path}.params.npz"


def wait_params(proc, out_path, timeout_s: float = 300.0) -> dict:
    """The parameters file of a running ``models`` child, once written."""
    import os
    import time
    path, deadline = params_path(out_path), time.monotonic() + timeout_s
    while not os.path.exists(path):
        if proc.poll() is not None:
            finish_jax(proc, out_path)      # raises with the child's stderr
        if time.monotonic() > deadline:
            raise TimeoutError(f"no parameters from the JAX child in "
                               f"{timeout_s} s")
        time.sleep(0.2)
    with np.load(path) as data:
        return dict(data)


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
