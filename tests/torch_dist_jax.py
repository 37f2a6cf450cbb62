"""The JAX side of the port's distributed parity tests.

Run in a child interpreter with 8 host devices, as tests/test_multidevice.py
runs its suite (the main pytest process must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_dist_jax.py {primitives|linop} OUT.npz [CHAINS.json]

For every case of ``torch_dist_cases`` it writes the global forward, the
vector-Jacobian product for the case's cotangent and the Eq. 13 ratio of
that vjp, keyed ``<case>/<what>``.  Each case is one jitted program: the
reference's own harness runs eagerly, which on 8 host devices takes
seconds a case.  ``CHAINS.json`` carries the fuzzer's
chains (linop only).
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_dist_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.core import linop, primitives as prim  # noqa: E402
from repro.core.adjoint import inner, norm  # noqa: E402
from repro.core.partition import compute_halos  # noqa: E402

_MESHES = {}


def mesh(name):
    if name not in _MESHES:
        shape, axes = C.MESHES[name]
        _MESHES[name] = compat.make_mesh(shape, axes)
    return _MESHES[name]


def _fx_vjp(F, x, seed, y=None):
    """F(x) and its vjp for the cotangent ``y`` (drawn from ``seed`` at
    F(x)'s shape when None), in one jitted program; and the Eq. 13 ratio
    of that vjp, as repro.core.adjoint.adjoint_test computes it."""
    if y is None:
        y = C.draw(jax.eval_shape(F, x).shape, seed)
    y = jnp.asarray(y)

    @jax.jit
    def both(x, y):
        fx, vjp = jax.vjp(F, x)
        return fx, vjp(y)[0]
    fx, fstar = both(x, y)
    denom = jnp.maximum(norm(fx) * norm(y), norm(x) * norm(fstar))
    rel = float(jnp.abs(inner(fx, y) - inner(x, fstar))
                / jnp.maximum(denom, 1e-30))
    return {"fx": np.asarray(fx), "vjp": np.asarray(fstar), "rel": rel}


def run_body_cases(cases: dict, out: dict):
    """Primitive bodies lifted by shard_map over the cases' specs; for the
    replicated pair also JAX's own pair (``<case>/own_*``)."""
    for cid, case in cases.items():
        variants = {"": False, "own_": "own"} if case.get("own") else {"": 0}
        for prefix, flag in variants.items():
            body = case["body"](prim, jax.lax.axis_index, flag)
            f = prim.smap(body, mesh(case["mesh"]),
                          tuple(P(*s) for s in case["specs"]),
                          P(*case["out"]))
            inputs = [jnp.asarray(a) for a in case["inputs"]]
            lin = case["lin"]

            def g(v, inputs=inputs, lin=lin, f=f):
                return f(*inputs[:lin], v, *inputs[lin + 1:])
            res = _fx_vjp(g, inputs[lin], case["seed"], case.get("y"))
            out.update({f"{cid}/{prefix}{k}": v for k, v in res.items()})


def run_op(cid: str, mname: str, op, shape, out: dict, adjoint=True):
    """The lifted op's forward and vjp on the case's draws (the same ones
    the port's side draws), and the same for ``op.T``."""
    seed = C.seed_of(cid)
    F = linop.lift(op, mesh(mname), len(shape))
    res = _fx_vjp(F, jnp.asarray(C.draw(shape, seed)), seed + 1)
    out.update({f"{cid}/{k}": v for k, v in res.items()})
    if adjoint:
        run_op(cid + ".T", mname, op.T, res["fx"].shape, out, adjoint=False)


def main(argv):
    which, path = argv[0], argv[1]
    out = {}
    if which == "primitives":
        run_body_cases(C.prim_cases(), out)
        run_body_cases(C.sweep_cases(), out)
    elif which == "linop":
        for cid, (mname, op, shape) in C.linop_cases(
                linop, compute_halos).items():
            run_op(cid, mname, op, shape, out)
        with open(argv[2]) as fh:
            chains = json.load(fh)
        for i, chain in enumerate(chains):
            op = C.chain_of(linop, chain["ops"])
            run_op(f"fuzz{i}", chain["mesh"], op, tuple(chain["shape"]), out,
                   adjoint=False)
    else:
        raise SystemExit(f"unknown case set {which!r}")
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1:])
