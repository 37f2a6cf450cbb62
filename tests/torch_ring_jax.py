"""The JAX side of the port's context-parallel parity test.

Run in a child interpreter with 8 host devices (the main pytest process
must see exactly one device):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/torch_ring_jax.py OUT.npz

First the inputs of every case, drawn with tests/md/test_ring_attention.py's
keys, and the reference's own parameters, written at once to
``torch_region_cases.params_path(OUT)``: ``ring/<case>/{q,k,v,g}``,
``gqa/{q,k,v,g}``, ``p<S>/<key>`` (``init_pipeline_params(CFG,
PRNGKey(0), S)``), ``data/{tokens,labels}`` (test_hybrid.py's ``_data``),
``fwd/params/<key>`` and ``fwd/{tokens,labels}``, and ``cli/params/<key>``
(the CLI's own init of reduced glm4-9b at seed 0).  Then, each case as one
jitted program: ``ring_attention`` over the (8,) ctx mesh and
``blockwise_attention`` (``ring/<case>/{out,ref}`` and their vjps
``.../grad_{q,k,v}``, ``.../ref_grad_{q,k,v}``), ``ring_attention_gspmd``
with KH < tp (``gqa/...``), the executor on every hybrid mesh
(``hybrid/<case>/loss``, ``hybrid/<case>/grad/<key>``), ``forward`` over
(2, 2, 2) and without a policy (``fwd/{cp,ref}/loss``, ``.../grad/<key>``),
and the CLI's history at ``--hybrid-mesh 2,1,2,2`` (``cli/loss``, one loss
a step).
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"), HERE]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import torch_region_cases as RC  # noqa: E402
import torch_ring_cases as C  # noqa: E402
from repro import compat  # noqa: E402
from repro.configs import ModelConfig, get_config, reduced  # noqa: E402
from repro.core import primitives as prim  # noqa: E402
from repro.core.pipeline import (make_schedule,  # noqa: E402
                                 pipeline_value_and_grad)
from repro.core.ring_attention import (ring_attention,  # noqa: E402
                                       ring_attention_gspmd)
from repro.launch.mesh import make_hybrid_mesh  # noqa: E402
from repro.models import (forward, init_params,  # noqa: E402
                          init_pipeline_params, pipeline_fns,
                          pipeline_param_parts)
from repro.models.attention import blockwise_attention  # noqa: E402
from repro.sharding import Partitioned, Policy  # noqa: E402
from repro.train import cross_entropy  # noqa: E402

CFG = ModelConfig(**C.CFG)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(d):
    tree = {}
    for k, v in d.items():
        node = tree
        *path, last = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(v)
    return tree


def qkvg(B, S, H, KH, hd):
    """test_ring_attention.py's draws: q, k, v and the output cotangent."""
    key = jax.random.PRNGKey(0)
    q = jax.random.normal(key, (B, S, H, hd), jnp.float32)
    k = jax.random.normal(jax.random.fold_in(key, 1), (B, S, KH, hd),
                          jnp.float32)
    v = jax.random.normal(jax.random.fold_in(key, 2), (B, S, KH, hd),
                          jnp.float32)
    g = jax.random.normal(jax.random.fold_in(key, 3), (B, S, H, hd))
    return {"q": q, "k": k, "v": v, "g": g}


def init(path):
    out = {}
    for case, (B, S, H, KH, hd, _, _) in C.RING_CASES.items():
        out.update({f"ring/{case}/{n}": np.asarray(a)
                    for n, a in qkvg(B, S, H, KH, hd).items()})
    B, S, H, KH, hd, _ = C.GQA_CASE
    out.update({f"gqa/{n}": np.asarray(a)
                for n, a in qkvg(B, S, H, KH, hd).items()})
    for S in sorted({shape[1] for shape, _ in C.HYBRID_CASES.values()}):
        pp = init_pipeline_params(CFG, jax.random.PRNGKey(0), S)
        out.update({f"p{S}/{k}": v for k, v in flat(pp).items()})
    key = jax.random.PRNGKey(1)       # test_hybrid.py::_data
    shape = (C.HYBRID_BATCH, C.HYBRID_SEQ)
    out["data/tokens"] = np.asarray(jax.random.randint(
        key, shape, 0, CFG.vocab_size))
    out["data/labels"] = np.asarray(jax.random.randint(
        jax.random.fold_in(key, 1), shape, 0, CFG.vocab_size))
    out.update({f"fwd/params/{k}": v for k, v in
                flat(init_params(CFG, jax.random.PRNGKey(0))).items()})
    key = jax.random.PRNGKey(3)
    shape = (C.FWD_BATCH, C.FWD_SEQ)
    out["fwd/tokens"] = np.asarray(jax.random.randint(key, shape, 0, 128))
    out["fwd/labels"] = np.asarray(jax.random.randint(
        jax.random.fold_in(key, 1), shape, 0, 128))
    cli_cfg = reduced(get_config(C.CLI["arch"]))
    out.update({f"cli/params/{k}": v for k, v in flat(init_pipeline_params(
        cli_cfg, jax.random.PRNGKey(C.CLI["seed"]), C.CLI["hybrid"][1]))
        .items()})
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)
    return out


def _vjp(out, prefix, f, ref_f, d):
    q, k, v, g = (jnp.asarray(d[n]) for n in "qkvg")

    def both(q, k, v):
        y, vjp = jax.vjp(f, q, k, v)
        r, vjp_r = jax.vjp(ref_f, q, k, v)
        return y, vjp(g), r, vjp_r(g)

    y, grads, r, ref_grads = jax.jit(both)(q, k, v)
    out[f"{prefix}/out"], out[f"{prefix}/ref"] = y, r
    for n, a, b in zip("qkv", grads, ref_grads):
        out[f"{prefix}/grad_{n}"], out[f"{prefix}/ref_grad_{n}"] = a, b


def run_ring(out, init_out):
    mesh = compat.make_mesh((8,), ("ctx",))
    for case, (_, _, _, _, _, chunk, causal) in C.RING_CASES.items():
        f = prim.smap(
            lambda q, k, v, c=causal, n=chunk: ring_attention(
                q, k, v, "ctx", chunk=n, causal=c),
            mesh, (P(None, "ctx"),) * 3, P(None, "ctx"))
        _vjp(out, f"ring/{case}", f,
             lambda q, k, v, c=causal, n=chunk: blockwise_attention(
                 q, k, v, chunk=n, causal=c),
             C.subtree(init_out, f"ring/{case}"))
    chunk = C.GQA_CASE[-1]
    pol = Policy(mesh=compat.make_mesh(C.GQA_MESH, ("data", "ctx", "model")),
                 ctx_axis="ctx")
    _vjp(out, "gqa",
         lambda q, k, v: ring_attention_gspmd(q, k, v, pol, chunk=chunk),
         lambda q, k, v: blockwise_attention(q, k, v, chunk=chunk),
         C.subtree(init_out, "gqa"))


def run_hybrid(out, init_out):
    """test_ring_attention.py::_cp_loss_and_grads on every mesh."""
    M = C.HYBRID_M
    xs = {"tokens": jnp.asarray(init_out["data/tokens"]).reshape(
        M, -1, C.HYBRID_SEQ)}
    ys = jnp.asarray(init_out["data/labels"]).reshape(M, -1, C.HYBRID_SEQ)
    for cid, ((dp, S, cp, tp), explicit) in C.HYBRID_CASES.items():
        mesh = make_hybrid_mesh(dp, S, cp, tp)
        pol = Policy.for_mesh(mesh, explicit_tp=explicit)
        pparams = unflat(C.subtree(init_out, f"p{S}"))
        pre_fn, stage_fn, logits_fn = pipeline_fns(CFG, pol)

        def post_fn(p_post, y, labels):
            return cross_entropy(logits_fn(p_post, y), labels)[0]

        mb_part = Partitioned(None, "data", "ctx")
        f = pipeline_value_and_grad(
            pre_fn, stage_fn, post_fn, pol, make_schedule("1f1b", M, S),
            params_parts=pipeline_param_parts(CFG, pol, pparams),
            x_parts={"tokens": mb_part}, y_parts=mb_part,
            pre_psum_axes=(pol.model_axis,) if explicit else ())
        loss, grads = jax.jit(f)(pparams, xs, ys)
        out[f"hybrid/{cid}/loss"] = loss
        out.update({f"hybrid/{cid}/grad/{k}": v
                    for k, v in flat(grads).items()})


def run_forward(out, init_out):
    """test_ring_attention.py::TestFusedTPRing: forward over (2, 2, 2)."""
    params = unflat(C.subtree(init_out, "fwd/params"))
    batch = {k: jnp.asarray(init_out[f"fwd/{k}"]) for k in ("tokens",
                                                            "labels")}

    def loss_fn(pol):
        def f(p):
            logits, _, _ = forward(p, batch, CFG, pol, mode="train")
            return cross_entropy(logits, batch["labels"])[0]
        return f

    mesh = compat.make_mesh(C.FWD_MESH, ("data", "ctx", "model"))
    pol = Policy(mesh=mesh, ctx_axis="ctx", explicit_tp=True)
    for name, p in (("ref", None), ("cp", pol)):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn(p)))(params)
        out[f"fwd/{name}/loss"] = loss
        out.update({f"fwd/{name}/grad/{k}": v
                    for k, v in flat(grads).items()})


def run_cli(out):
    """The reference's CLI at ``--hybrid-mesh 2,1,2,2``: one loss a step."""
    import repro.launch.train as T

    losses = []
    real = T.restart_on_failure

    def recording(*a, **kw):
        state, hist = real(*a, **kw)
        losses.extend(float(rec["loss"]) for rec in hist)
        return state, hist

    T.restart_on_failure = recording
    argv = sys.argv
    sys.argv = ["train", "--arch", C.CLI["arch"], "--reduced",
                "--hybrid-mesh", ",".join(map(str, C.CLI["hybrid"])),
                "--microbatches", str(C.CLI["microbatches"]),
                "--steps", str(C.CLI["steps"]), "--batch",
                str(C.CLI["batch"]), "--seq", str(C.CLI["seq"]),
                "--seed", str(C.CLI["seed"])]
    try:
        T.main()
    finally:
        sys.argv, T.restart_on_failure = argv, real
    out["cli/loss"] = np.asarray(losses)


def main(argv):
    (path,) = argv
    init_out = init(RC.params_path(path))
    out = {}
    run_ring(out, init_out)
    run_hybrid(out, init_out)
    run_forward(out, init_out)
    run_cli(out)
    assert len(jax.devices()) == 8, jax.devices()
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1:])
