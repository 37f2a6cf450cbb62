"""The models of the port's region layer against the JAX package's:
LeNet-5 (``repro_torch/models/lenet.py``, paper §5) and the explicit-TP
attention+MLP sublayer (``models/blocks.py::_tp_sublayer_apply``).

A child interpreter with 8 host devices (``torch_region_jax.py models``)
first writes the reference's own parameters and LeNet's data; one pool of
8 gloo ranks then carries them over leaf by leaf
(``models/convert.py::params_from_jax``) while the child computes its
side.  LeNet on the 2x2 (fo, fi) mesh: the forward within 2e-4 and every
grad within 2e-3 of JAX's ``lenet_apply_distributed`` and of the port's
sequential net, five SGD steps' losses within 1e-3, Table 1's shapes
(tests/md/test_lenet_md.py); also distributed == sequential on a (1, 1)
mesh, the card's world.  The sublayer (TestFusedTransformerSublayer's
config, fp32) on (data, model) = (2, 4) and (2, 2): forward within 2e-4
and grads within 5e-4 of JAX's ``sublayer_apply(policy=None)``.
"""

import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_region_cases as C
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lenet as LN
from repro_torch.models.blocks import sublayer_apply
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding import Policy

POOL_TIMEOUT_S = 600


def _tree(init, prefix) -> dict:
    """The reference's nested tree (numpy leaves) under ``prefix/``."""
    out = {}
    for key, leaf in init.items():
        if key.startswith(prefix + "/"):
            *parents, name = key[len(prefix) + 1:].split(".")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
    return out


def _leaves(params):
    return {k: v.clone().requires_grad_() for k, v in params.items()}


def _xent(logits, y):
    return F.cross_entropy(logits, y.long())


def _lenet(mesh, init, out):
    params = params_from_jax(_tree(init, "lenet"))
    x, y = (torch.from_numpy(init[f"data/{k}"]) for k in "xy")
    pd, ps = _leaves(params), _leaves(params)
    logits = LN.lenet_apply_distributed(mesh, pd, x)
    seq = LN.lenet_apply_sequential(ps, x)
    gd = torch.autograd.grad(_xent(logits, y), list(pd.values()))
    gs = torch.autograd.grad(_xent(seq, y), list(ps.values()))
    out["fx"], out["seq_fx"] = logits.detach(), seq.detach()
    out["grad"] = dict(zip(pd, gd))
    out["seq_grad"] = dict(zip(ps, gs))
    # five SGD steps, distributed and sequential from one init
    pd = params_from_jax(_tree(init, "lenet_train"))
    ps = dict(pd)
    xt, yt = (torch.from_numpy(init[f"train_data/{k}"]) for k in "xy")
    losses = {"dist": [], "seq": []}
    for _ in range(C.LENET_STEPS):
        for name, apply in (("dist", functools.partial(
                LN.lenet_apply_distributed, mesh)),
                ("seq", LN.lenet_apply_sequential)):
            p = _leaves(pd if name == "dist" else ps)
            loss = _xent(apply(p, xt), yt)
            g = torch.autograd.grad(loss, list(p.values()))
            new = {k: (v - C.LENET_LR * gk).detach()
                   for (k, v), gk in zip(p.items(), g)}
            losses[name].append(float(loss))
            if name == "dist":
                pd = new
            else:
                ps = new
    out["train_losses"] = losses
    out["table1"] = json.dumps(LN.table1_local_shapes((2, 2)))


def _lenet_world1(mesh, init) -> dict:
    params = params_from_jax(_tree(init, "lenet"))
    x, y = (torch.from_numpy(init[f"data/{k}"]) for k in "xy")
    pd, ps = _leaves(params), _leaves(params)
    ld = _xent(LN.lenet_apply_distributed(mesh, pd, x), y)
    ls = _xent(LN.lenet_apply_sequential(ps, x), y)
    gd = torch.autograd.grad(ld, list(pd.values()))
    gs = torch.autograd.grad(ls, list(ps.values()))
    return {"loss": [float(ld), float(ls)],
            "grad_err": max(float((a - b).abs().max())
                            for a, b in zip(gd, gs))}


def _tp(mesh, init) -> dict:
    cfg = ModelConfig(**C.TP_CFG)
    p = _leaves(params_from_jax(_tree(init, "tp")))
    x, positions = (torch.from_numpy(a) for a in C.tp_inputs())
    pol = Policy(mesh, explicit_tp=True, fsdp=False, seq_shard=False)
    y, _, _ = sublayer_apply(p, x, cfg, 0, positions=positions, mode="train",
                             policy=pol)
    grads = torch.autograd.grad((y.float() ** 2).sum(), list(p.values()))
    return {"fx": y.detach(), "grad": dict(zip(p, grads))}


def _rank_fn(rank, mesh1d, init):
    out = {}
    meshes = {name: tmesh.make_host_mesh(*C.MESHES[name], device="cpu")
              for name in ("fofi", "2d", "tp2")}
    one = tmesh.make_host_mesh((1, 1), ("fo", "fi"), device="cpu")
    if meshes["fofi"] is not None:
        out["lenet"] = {}
        _lenet(meshes["fofi"], init, out["lenet"])
    if one is not None:
        out["lenet_world1"] = _lenet_world1(one, init)
    for tp, name in C.TP_MESHES.items():
        if meshes[name] is not None:
            out[tp] = _tp(meshes[name], init)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "models.npz"
    child = C.start_jax("models", path)
    try:
        init = C.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = C.finish_jax(child, path)
    return ranks, jax_out


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def test_lenet_forward_matches_reference_and_sequential(results):
    ranks, jax_out = results
    for r in range(4):
        got = ranks[r]["lenet"]
        _close(got["fx"], jax_out["lenet/fx"], C.LENET_FWD, f"rank {r}")
        _close(got["fx"], got["seq_fx"], C.LENET_FWD, f"rank {r} vs seq")
    _close(ranks[0]["lenet"]["seq_fx"], jax_out["lenet/seq_fx"], C.LENET_FWD,
           "sequential nets")


@pytest.mark.parametrize("leaf", ["conv1.w", "conv1.b", "conv2.w", "conv2.b",
                                  "fc1.w", "fc1.b", "fc2.w", "fc2.b",
                                  "fc3.w", "fc3.b"])
def test_lenet_grads_match_reference_and_sequential(results, leaf):
    ranks, jax_out = results
    got = ranks[0]["lenet"]
    _close(got["grad"][leaf], jax_out[f"lenet/grad/{leaf}"], C.LENET_GRAD,
           leaf)
    _close(got["grad"][leaf], got["seq_grad"][leaf], C.LENET_GRAD, leaf)


def test_lenet_five_sgd_steps(results):
    ranks, jax_out = results
    losses = ranks[0]["lenet"]["train_losses"]
    ref = jax_out["lenet/train_losses"]
    for i, (d, s, j) in enumerate(zip(losses["dist"], losses["seq"], ref)):
        assert abs(d - j) < C.LENET_LOSS, (i, d, j)
        assert abs(d - s) < C.LENET_LOSS, (i, d, s)


def test_lenet_table1_shapes(results):
    ranks, jax_out = results
    got = json.loads(ranks[0]["lenet"]["table1"])
    assert got == json.loads(str(jax_out["lenet/table1"]))
    assert got == {"C5": [60, 200], "F6": [42, 60], "Output": [5, 42]}


def test_lenet_world_one_equals_sequential(results):
    """The (1, 1) mesh the one-card machine runs: every halo is the global
    padding and the crop keeps rows 2..12 on the one worker."""
    got = results[0][0]["lenet_world1"]
    assert abs(got["loss"][0] - got["loss"][1]) < 1e-6, got
    assert got["grad_err"] < 1e-5, got
    assert all("lenet_world1" not in r for r in results[0][1:])


@pytest.mark.parametrize("tp", list(C.TP_MESHES))
def test_tp_sublayer_matches_reference(results, tp):
    """The explicit-TP sublayer (ring matmuls, sharded RMSNorm, head-local
    attention through ops.flash_attention) against the reference's
    single-process sublayer_apply, on every rank of the mesh."""
    ranks, jax_out = results
    n = 8 if C.TP_MESHES[tp] == "2d" else 4
    for r in range(n):
        got = ranks[r][tp]
        _close(got["fx"], jax_out["tp/fx"], C.TP_FWD, f"{tp} rank {r}")
        for leaf, g in got["grad"].items():
            _close(g, jax_out[f"tp/grad/{leaf}"], C.TP_GRAD,
                   f"{tp} rank {r} grad {leaf}")
