"""The port's region layer (``repro_torch/sharding``, ``core/compile.py``,
``core/overlap.py``, ``core/layers.py``) against the JAX package's.

One pool of 8 gloo ranks (``mesh.spawn``) runs every case while a child
interpreter with 8 host devices runs the JAX side
(``torch_region_jax.py``), both on the same numpy draws
(``torch_region_cases.py``).  Each layer, ring and region case compares
the global forward and the global gradients of ``sum(y ** 2)`` with the
reference's at the pins of tests/md/test_layers_md.py, test_overlap.py
and test_dist_jit.py; the unused-axis cases also with the sequential
pool's gradients.  The spec and policy cases compare every resolution
fact over the meshes of tests/torch_dist_cases.py.  The pool also holds
the three-rank, offset-2, non-cyclic shift: a rank with neither source nor
destination takes no part in the batch of p2p operations, which the
mesh's first collective on every group makes legal under NCCL.
"""

import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_region_cases as C
from repro_torch.core import layers as L
from repro_torch.core import overlap
from repro_torch.core import primitives as prim
from repro_torch.core.compile import dist_jit
from repro_torch.core.linop import P
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import Partitioned, Policy

POOL_TIMEOUT_S = 600
CASES = C.layer_cases()
NS = SimpleNamespace(L=L, overlap=overlap, dist_jit=dist_jit,
                     Partitioned=Partitioned, Policy=Policy, P=P)


def _eval(case, m) -> dict:
    inputs = [torch.from_numpy(a) for a in case["inputs"]]
    for i in case["grads"]:
        inputs[i] = inputs[i].clone().requires_grad_()
    y = case["body"](NS, m)(*inputs)
    out = {"fx": y.detach()}
    if case["grads"]:
        gs = torch.autograd.grad((y ** 2).sum(),
                                 [inputs[i] for i in case["grads"]])
        out.update({f"g{i}": g for i, g in zip(case["grads"], gs)})
    return out


def _unused_axis_seq(case, op) -> np.ndarray:
    """The sequential pool's gradient of sum(y ** 2)."""
    x = torch.from_numpy(case["inputs"][0]).requires_grad_()
    pool = F.max_pool2d if op == "max" else F.avg_pool2d
    (g,) = torch.autograd.grad((pool(x, 2, 2) ** 2).sum(), x)
    return g


def _shift_three_ranks(rank) -> dict:
    """send_recv by +2 on a non-cyclic axis of 3 ranks: rank 2 receives
    rank 0's block; ranks 0 and 1 receive zeros; rank 1 posts nothing.
    The adjoint sends the cotangent back by -2."""
    m = tmesh.make_host_mesh((3,), ("model",), device="cpu")
    if m is None:
        return {}
    with prim.use_mesh(m):
        x = torch.full((4,), float(rank + 1), requires_grad=True)
        y = prim.send_recv(x, "model", 2)
        (g,) = torch.autograd.grad(y, x, torch.full((4,), 10.0 * (rank + 1)))
    return {"y": y.detach(), "g": g}


def _rank_fn(rank, mesh1d):
    warnings.simplefilter("ignore", DeprecationWarning)
    out = {"shift3": _shift_three_ranks(rank)}
    meshes = {"1d": mesh1d}
    for name, (shape, axes) in C.MESHES.items():
        if name not in meshes:
            meshes[name] = tmesh.make_host_mesh(shape, axes, device="cpu")
    for cid, case in CASES.items():
        if meshes[case["mesh"]] is not None:
            out[cid] = _eval(case, meshes[case["mesh"]])
    for op in ("max", "avg"):
        out[f"seq_pool_{op}"] = _unused_axis_seq(
            CASES[f"pool_{op}_unused_axis"], op)
    for name, (shape, axes) in C.POLICY_MESHES.items():
        m = tmesh.make_host_mesh(shape, axes, device="cpu")
        out[f"policy/{name}"] = C.policy_facts(NS, m, axes)
    out["boundary_errors"] = C.boundary_errors(NS, meshes["2d"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        L.dist_pool(meshes["hw"], torch.zeros(1, 1, 8, 16), k=2, stride=2,
                    spatial_axes=("h", "w"))
    out["shim_warnings"] = [f"{w.category.__name__}: {w.message}"
                            for w in caught
                            if issubclass(w.category, DeprecationWarning)]
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "region.npz"
    child = C.start_jax("region", path)
    try:
        ranks = tmesh.spawn(_rank_fn, 8, device="cpu",
                            timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = C.finish_jax(child, path)
    return ranks, jax_out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("cid", list(CASES))
def test_layer_matches_reference(results, cid):
    """Global forward and gradients equal the JAX package's at the
    reference file's pins, the same on every rank."""
    ranks, jax_out = results
    case = CASES[cid]
    port = ranks[0][cid]
    for r, other in enumerate(ranks[1:], 1):
        for key, val in port.items():
            np.testing.assert_array_equal(other[cid][key], val,
                                          err_msg=f"{cid} rank {r} {key}")
    _close(port["fx"], jax_out[f"{cid}/fx"], case["fwd"], f"{cid} forward")
    for i in case["grads"]:
        _close(port[f"g{i}"], jax_out[f"{cid}/g{i}"], case["grad"],
               f"{cid} grad of input {i}")


@pytest.mark.parametrize("op", ["max", "avg"])
def test_unused_axis_grads_equal_sequential(results, op):
    """dist_pool on (h, w) = (2, 4) with spatial_axes ("h", None): "w" is
    in no spec, every rank along it computes the same thing, and the input
    gradient equals the sequential pool's, not 4 times it."""
    port = results[0][0]
    got = port[f"pool_{op}_unused_axis"]["g0"]
    want = port[f"seq_pool_{op}"]
    _close(got, want, 1e-5, f"unused-axis {op} pool grad")
    _close(port[f"pool_{op}_unused_axis"]["fx"],
           results[1][f"pool_{op}_unused_axis/fx"], 2e-5, op)


@pytest.mark.parametrize("name", list(C.POLICY_MESHES))
def test_policy_resolution_matches_reference(results, name):
    """resolve_axis, spec, the axis-size properties, param_spec, the
    aliases of test_dist_jit.py:128-141 and Replicated, for three policies
    over each mesh."""
    ranks, jax_out = results
    port = json.loads(ranks[0][f"policy/{name}"])
    ref = json.loads(str(jax_out[f"policy/{name}"]))
    assert port.keys() == ref.keys()
    for pol in ref:
        for key in ref[pol]:
            assert port[pol][key] == ref[pol][key], (name, pol, key)


def test_boundary_errors_match_reference(results):
    """An absent mesh axis and an axis on two dims raise SpaceTypeError
    before anything runs, as in the reference."""
    ranks, jax_out = results
    port = json.loads(ranks[0]["boundary_errors"])
    assert port == json.loads(str(jax_out["boundary_errors"]))
    assert port["absent axis"] == ["SpaceTypeError", True, False]
    assert port["axis twice"] == ["SpaceTypeError", False, True]


def test_shims_warn_deprecated(results):
    """The dist_* shims run through dist_jit and say so, as the
    reference's (repro/core/layers.py:70-82)."""
    (msg,) = results[0][0]["shim_warnings"]
    assert msg.startswith("DeprecationWarning: dist_pool is a deprecated")
    assert "layers.pool inside a dist_jit region" in msg


def test_send_recv_offset_two_on_three_ranks(results):
    ranks, _ = results
    ys = [ranks[r]["shift3"]["y"] for r in range(3)]
    gs = [ranks[r]["shift3"]["g"] for r in range(3)]
    np.testing.assert_array_equal(ys[0], 0)
    np.testing.assert_array_equal(ys[1], 0)
    np.testing.assert_array_equal(ys[2], 1.0)          # rank 0's block
    np.testing.assert_array_equal(gs[0], 30.0)         # rank 2's cotangent
    np.testing.assert_array_equal(gs[1], 0)
    np.testing.assert_array_equal(gs[2], 0)
    assert all(ranks[r]["shift3"] == {} for r in range(3, 8))
