"""The port's context parallelism (``core/ring_attention.py`` and the ctx
axis of the hybrid step) against the JAX package, on one pool of 8 gloo
ranks beside a child interpreter with 8 host devices
(``torch_ring_jax.py``) that runs the cases of
tests/md/test_ring_attention.py on the same draws and parameters, each as
one jitted program.  Global values, losses, vjps and grads are compared,
never per-rank cotangents (README, "Cotangent convention").

- KVRingShift: Eq. 13 on the (8,) ctx mesh and the 4-D (2, 1, 2, 2) mesh
  at offsets +-1 and +-3; eight hops are the identity; ``.T`` is the
  reverse rotation.
- ``ring_attention`` over (8,) against the reference's ring and
  ``blockwise_attention``, forward (2e-5) and vjp (rtol 5e-4, atol 5e-5),
  at (KH, causal) in (8, T), (2, T), (1, T), (4, F) and a ragged shard
  (S_loc % chunk != 0); ``ring_attention_region`` with KH < tp on
  (data, ctx, model) = (1, 2, 4).
- The hybrid executor at (dp, pp, cp, tp) = (2, 1, 2, 2), (1, 1, 4, 2),
  (2, 1, 4, 1) without explicit TP and (1, 2, 2, 2) with a pipe axis:
  loss (rtol 2e-5) and every grad (5e-4) against the reference's executor
  and the port's single-device forward.
- ``forward`` over (data, ctx, model) = (2, 2, 2) with explicit TP, and
  without it (one ``ring_attention_region`` a layer), against
  ``policy=None`` and the reference's.
- cp = 1 gives the 3-D mesh; a size-1 ctx axis deactivates and matches
  the 3-D path; a sequence the ctx axis does not divide raises in the
  step and in the region.
- The CLI's per-rank path at ``--hybrid-mesh 2,1,2,2`` from the
  reference CLI's own initial parameters: every step's loss against the
  reference CLI's; the CLI itself (its own init) runs the same path.
- Host only: the working-set model and its refusal equal the reference's;
  SSM mixers under CP > 1 raise in the stage body and in ``check_hybrid``.
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_region_cases as RC
import torch_ring_cases as C
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.core import linop
from repro_torch.core import ring_attention as ra
from repro_torch.core.compile import dist_jit
from repro_torch.core.linop import PartitionSpec as P
from repro_torch.core.linop import check_adjoint
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import (forward, from_pipeline_params,
                                init_pipeline_params, to_pipeline_params)
from repro_torch.models.blocks import pipeline_stage_body
from repro_torch.models.convert import params_from_jax, to_rank_params
from repro_torch.optim import make_optimizer
from repro_torch.sharding import Policy
from repro_torch.train import (build_hybrid_train_step,
                               build_hybrid_value_and_grad, build_loss_fn,
                               cross_entropy, init_train_state)

CFG = ModelConfig(**C.CFG)
POOL_TIMEOUT_S = 600
OFFSETS = (-3, -1, 1, 3)


def _single_device(pparams, tokens, labels):
    """The port's fp32 single-device loss and grads, in pipeline layout."""
    loss_fn = build_loss_fn(CFG)
    dense = {k: v.clone().requires_grad_() for k, v in
             from_pipeline_params(pparams).items()}
    n = tokens.shape[0]
    tot = sum(loss_fn(dense, {"tokens": tokens[m], "labels": labels[m]})[0]
              for m in range(n)) / n
    grads = torch.autograd.grad(tot, list(dense.values()))
    S = pparams["stage.pos0.attn.wq"].shape[0]
    return float(tot), to_pipeline_params(CFG, dict(zip(dense, grads)), S)


def _vjp(f, d):
    q, k, v = (torch.from_numpy(d[n]).requires_grad_() for n in "qkv")
    out = f(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(d["g"]))
    return {"out": out.detach(), **{f"grad_{n}": g
                                    for n, g in zip("qkv", grads)}}


def _eq13(rank, out):
    m8 = tmesh.make_host_mesh((8,), ("ctx",), device="cpu")
    m4d = tmesh.make_host_mesh((2, 1, 2, 2), ("data", "pipe", "ctx",
                                              "model"), device="cpu")
    eq = {}
    for name, mesh, shape in (("1d", m8, (16, 4)), ("4d", m4d, (8, 4))):
        for off in OFFSETS:
            r = check_adjoint(linop.KVRingShift("ctx", off), mesh, shape)
            eq[f"{name}{off:+d}"] = [bool(r.passed), float(r.rel_err)]
    chain = linop.KVRingShift("ctx", 1)
    for _ in range(7):
        chain = linop.KVRingShift("ctx", 1) @ chain
    x = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    eq["identity"] = bool(torch.equal(linop.lift(chain, m8, 2)(x), x))
    out["eq13"] = eq
    return m8


def _ring_cases(rank, out, init, m8):
    pol8 = Policy.for_mesh(m8)
    out["ring"] = {}
    for case, (_, _, _, _, _, chunk, causal) in C.RING_CASES.items():
        def body(q, k, v, chunk=chunk, causal=causal):
            return ra.ring_attention(q, k, v, "ctx", chunk=chunk,
                                     causal=causal)

        f = dist_jit(body, pol8, (P(None, "ctx"),) * 3, P(None, "ctx"))
        out["ring"][case] = _vjp(f, C.subtree(init, f"ring/{case}"))
    gqa_mesh = tmesh.make_host_mesh(C.GQA_MESH, ("data", "ctx", "model"),
                                    device="cpu")
    if gqa_mesh is not None:
        pol = Policy(mesh=gqa_mesh, ctx_axis="ctx")
        chunk = C.GQA_CASE[-1]
        out["gqa"] = _vjp(lambda q, k, v: ra.ring_attention_region(
            q, k, v, pol, chunk=chunk), C.subtree(init, "gqa"))
    # a sequence the ctx axis does not divide: the region refuses it
    m181 = tmesh.make_host_mesh((1, 8, 1), ("data", "ctx", "model"),
                                device="cpu")
    q = torch.zeros(2, 20, 4, 8)
    try:
        ra.ring_attention_region(q, q, q, Policy(mesh=m181, ctx_axis="ctx"),
                                 chunk=8)
        out["raise_region"] = ""
    except ValueError as e:
        out["raise_region"] = str(e)


def _mbs(init):
    M = C.HYBRID_M
    return {k: torch.from_numpy(init[f"data/{k}"]).long().reshape(
        M, -1, C.HYBRID_SEQ) for k in ("tokens", "labels")}


def _hybrid_cases(rank, out, init):
    mbs = _mbs(init)
    out["hybrid"] = {}
    for cid, ((dp, S, cp, tp), explicit) in C.HYBRID_CASES.items():
        mesh = tmesh.make_hybrid_mesh(dp, S, cp, tp, device="cpu")
        pol = Policy.for_mesh(mesh, explicit_tp=explicit)
        assert pol.active_ctx_axis == "ctx" and pol.ctx_size == cp
        pvg, _ = build_hybrid_value_and_grad(CFG, pol,
                                             num_microbatches=C.HYBRID_M)
        params = params_from_jax(C.subtree(init, f"p{S}"))
        loss, grads = pvg(params, {"tokens": mbs["tokens"]}, mbs["labels"])
        out["hybrid"][cid] = {"loss": float(loss)}
        if rank == 0:
            ref_loss, ref_grads = _single_device(params, mbs["tokens"],
                                                 mbs["labels"])
            out["hybrid"][cid].update(grads=grads, ref_loss=ref_loss,
                                      ref_grads=ref_grads)


def _degenerate(rank, out, init):
    mbs = _mbs(init)
    m3 = tmesh.make_hybrid_mesh(2, 2, 1, tp=2, device="cpu")
    out["cp1_axes"] = list(m3.mesh_dim_names)
    m4 = tmesh.make_host_mesh((2, 2, 1, 2), ("data", "pipe", "ctx", "model"),
                              device="cpu")
    pol4 = Policy.for_mesh(m4, explicit_tp=True)
    out["size1"] = {"active": pol4.active_ctx_axis, "size": pol4.ctx_size,
                    "phys": pol4.phys("ctx"), "runs": []}
    p2 = params_from_jax(C.subtree(init, "p2"))
    for mesh in (m4, m3):
        pvg, _ = build_hybrid_value_and_grad(
            CFG, Policy.for_mesh(mesh, explicit_tp=True),
            num_microbatches=C.HYBRID_M)
        loss, grads = pvg(p2, {"tokens": mbs["tokens"]}, mbs["labels"])
        out["size1"]["runs"].append([float(loss), grads])
    # a sequence the ctx axis does not divide: the step refuses it
    m1142 = tmesh.make_hybrid_mesh(1, 1, 4, 2, device="cpu")
    pol = Policy.for_mesh(m1142, explicit_tp=True)
    opt = make_optimizer("adamw", total_steps=10)
    step = build_hybrid_train_step(CFG, pol, opt, num_microbatches=2)
    p1 = params_from_jax(C.subtree(init, "p1"))
    state = init_train_state(CFG, to_rank_params(CFG, pol, p1), opt)
    bad = {"tokens": np.zeros((8, 18), np.int32),
           "labels": np.zeros((8, 18), np.int32)}
    try:
        step(state, bad)
        out["raise_step"] = ""
    except ValueError as e:
        out["raise_step"] = str(e)


def _forward(rank, out, init):
    params = params_from_jax(C.subtree(init, "fwd/params"))
    batch = {k: torch.from_numpy(init[f"fwd/{k}"]).long()
             for k in ("tokens", "labels")}
    mesh = tmesh.make_host_mesh(C.FWD_MESH, ("data", "ctx", "model"),
                                device="cpu")
    out["fwd"] = {}
    for name, p in (("ref", None),
                    ("cp", Policy(mesh=mesh, ctx_axis="ctx",
                                  explicit_tp=True)),
                    ("cp_region", Policy(mesh=mesh, ctx_axis="ctx"))):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        logits, _, _ = forward(leaves, batch, CFG, mode="train", policy=p)
        loss = cross_entropy(logits, batch["labels"])[0]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["fwd"][name] = {"loss": float(loss),
                            "grads": dict(zip(leaves, grads))}


def _cli(rank, out, init):
    """``launch.train``'s per-rank path at the CLI's settings, from the
    reference CLI's initial parameters, then from the port's own."""
    cfg = reduced(get_config(C.CLI["arch"]))
    kw = dict(steps=C.CLI["steps"], batch=C.CLI["batch"], seq=C.CLI["seq"],
              microbatches=C.CLI["microbatches"], seed=C.CLI["seed"],
              device="cpu", logger=lambda line: None)
    jax_params = params_from_jax(C.subtree(init, "cli/params"))
    own = launch_train.init_pipeline_params
    launch_train.init_pipeline_params = lambda *a, **k: {
        n: v.clone() for n, v in jax_params.items()}
    try:
        _, hist, _ = launch_train.train_hybrid_rank(cfg, C.CLI["hybrid"],
                                                    **kw)
    finally:
        launch_train.init_pipeline_params = own
    _, own_hist, _ = launch_train.train_hybrid_rank(cfg, C.CLI["hybrid"],
                                                    **kw)
    out["cli"] = {"jax_init": [rec["loss"] for rec in hist],
                  "own_init": [rec["loss"] for rec in own_hist]}


def _rank_fn(rank, mesh1d, init):
    out = {}
    m8 = _eq13(rank, out)
    _ring_cases(rank, out, init, m8)
    _hybrid_cases(rank, out, init)
    _degenerate(rank, out, init)
    _forward(rank, out, init)
    _cli(rank, out, init)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "ring.npz"
    child = C.start_jax(path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, {**init, **jax_out}   # the draws beside the results


def _close(got, want, *, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# KVRingShift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["1d", "4d"])
@pytest.mark.parametrize("offset", OFFSETS)
def test_kv_ring_shift_passes_eq13(results, mesh, offset):
    for r, rank in enumerate(results[0]):
        passed, err = rank["eq13"][f"{mesh}{offset:+d}"]
        assert passed, (r, err)


def test_full_ring_is_identity(results):
    assert all(rank["eq13"]["identity"] for rank in results[0])


def test_kv_ring_shift_adjoint_is_the_reverse_rotation():
    assert linop.KVRingShift("ctx", 1).T == linop.KVRingShift("ctx", -1)
    assert linop.KVRingShift("ctx", -2).T.T == linop.KVRingShift("ctx", -2)


# ---------------------------------------------------------------------------
# ring_attention against the reference's ring and blockwise attention
# ---------------------------------------------------------------------------

def _assert_vjp(got, jax_out, prefix):
    for want in ("out", "ref"):
        _close(got["out"], jax_out[f"{prefix}/{want}"], rtol=C.FWD_TOL,
               atol=C.FWD_TOL, msg=f"{prefix} out vs {want}")
        for n in "qkv":
            key = f"grad_{n}" if want == "out" else f"ref_grad_{n}"
            _close(got[f"grad_{n}"], jax_out[f"{prefix}/{key}"],
                   rtol=C.GRAD_RTOL, atol=C.GRAD_ATOL,
                   msg=f"{prefix} d{n} vs {want}")


@pytest.mark.parametrize("case", list(C.RING_CASES))
def test_ring_attention_matches_reference(results, case):
    """Every rank's global output and vjp against the reference's ring on
    8 host devices and its ``blockwise_attention`` on the whole sequence."""
    ranks, jax_out = results
    for rank in ranks:
        _assert_vjp(rank["ring"][case], jax_out, f"ring/{case}")


def test_ring_attention_matches_port_blockwise(results):
    """The port's own plain attention on the gathered sequence, forward
    and vjp, for every case."""
    from repro_torch.kernels.ref import blockwise_attention
    ranks, jax_out = results
    for case, (_, _, _, _, _, chunk, causal) in C.RING_CASES.items():
        want = _vjp(lambda q, k, v: blockwise_attention(
            q, k, v, chunk=chunk, causal=causal),
            C.subtree(jax_out, f"ring/{case}"))
        got = ranks[0]["ring"][case]
        _close(got["out"], want["out"], rtol=C.FWD_TOL, atol=C.FWD_TOL,
               msg=case)
        for n in "qkv":
            _close(got[f"grad_{n}"], want[f"grad_{n}"], rtol=C.GRAD_RTOL,
                   atol=C.GRAD_ATOL, msg=f"{case} d{n}")


def test_region_repeats_kv_heads_below_tp(results):
    """KH = 2 < tp = 4 on (data, ctx, model) = (1, 2, 4): the region
    repeats the KV heads to H outside its boundary."""
    ranks, jax_out = results
    for rank in ranks:
        _assert_vjp(rank["gqa"], jax_out, "gqa")


# ---------------------------------------------------------------------------
# The hybrid step with a live ctx axis
# ---------------------------------------------------------------------------

def _assert_grads(got, want, what, *, rtol=C.HYBRID_TOL, atol=C.HYBRID_TOL):
    assert set(got) == set(want), what
    for k, g in got.items():
        _close(g, want[k], rtol=rtol, atol=atol, msg=f"{what}: {k}")


@pytest.mark.parametrize("cid", list(C.HYBRID_CASES))
def test_hybrid_cp_matches_reference(results, cid):
    """Loss on every rank and every grad leaf against the reference's
    executor and the port's single-device forward."""
    ranks, jax_out = results
    got = ranks[0]["hybrid"][cid]
    want_loss = float(jax_out[f"hybrid/{cid}/loss"])
    for rank in ranks:
        _close(rank["hybrid"][cid]["loss"], want_loss, rtol=C.LOSS_RTOL,
               atol=0.0, msg=f"{cid} loss")
    _close(got["ref_loss"], want_loss, rtol=C.LOSS_RTOL, atol=0.0)
    _assert_grads(got["grads"], C.subtree(jax_out, f"hybrid/{cid}/grad"),
                  f"{cid} vs JAX")
    _assert_grads(got["grads"], got["ref_grads"], f"{cid} vs single device")


def test_cp1_returns_the_3d_mesh(results):
    assert all(rank["cp1_axes"] == ["data", "pipe", "model"]
               for rank in results[0])


def test_size1_ctx_axis_deactivates(results):
    """A literal size-1 ctx axis: no active ctx axis, logical "ctx"
    resolves to None, and the executor matches the 3-D path."""
    for r, rank in enumerate(results[0]):
        got = rank["size1"]
        assert (got["active"], got["size"], got["phys"]) == (None, 1, None)
        (l4, g4), (l3, g3) = got["runs"]
        _close(l4, l3, rtol=1e-6, atol=0.0, msg=f"rank {r}")
        _assert_grads(g4, g3, f"rank {r}", rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("where", ["raise_step", "raise_region"])
def test_seq_not_divisible_by_cp_raises(results, where):
    for rank in results[0]:
        assert "not divisible" in rank[where], rank[where]


@pytest.mark.parametrize("want", ["ref", "jax"])
def test_forward_with_ctx_and_explicit_tp(results, want):
    """forward() over (data, ctx, model) = (2, 2, 2) with explicit TP:
    the fused region keeps the sequence ctx-sharded and rings inside;
    loss and every grad against policy=None (the port's and the
    reference's) and the reference's own run over the mesh."""
    ranks, jax_out = results
    for rank in ranks:
        got = rank["fwd"]["cp"]
        refs = ([("port", rank["fwd"]["ref"]["loss"],
                  rank["fwd"]["ref"]["grads"])] if want == "ref" else
                [(n, float(jax_out[f"fwd/{n}/loss"]),
                  C.subtree(jax_out, f"fwd/{n}/grad")) for n in ("ref", "cp")])
        for name, loss, grads in refs:
            _close(got["loss"], loss, rtol=C.GSPMD_LOSS_RTOL, atol=0.0,
                   msg=name)
            _assert_grads(got["grads"], grads, name,
                          rtol=C.GSPMD_GRAD_TOL, atol=C.GSPMD_GRAD_TOL)


def test_forward_with_ctx_rings_in_one_region(results):
    """forward() over the same mesh without explicit TP: attention rings
    through ``ring_attention_region`` (the reference's GSPMD dispatch);
    loss and every grad against policy=None, the port's and the
    reference's."""
    ranks, jax_out = results
    want = C.subtree(jax_out, "fwd/ref/grad")
    for rank in ranks:
        got = rank["fwd"]["cp_region"]
        for loss, grads in ((rank["fwd"]["ref"]["loss"],
                             rank["fwd"]["ref"]["grads"]),
                            (float(jax_out["fwd/ref/loss"]), want)):
            _close(got["loss"], loss, rtol=C.GSPMD_LOSS_RTOL, atol=0.0)
            _assert_grads(got["grads"], grads, "region",
                          rtol=C.GSPMD_GRAD_TOL, atol=C.GSPMD_GRAD_TOL)


def test_cli_path_matches_reference_cli(results):
    """Every step's loss of the CLI's per-rank path at ``--hybrid-mesh
    2,1,2,2`` from the reference CLI's initial parameters, on every rank,
    against the reference CLI's."""
    ranks, jax_out = results
    for rank in ranks:
        _close(rank["cli"]["jax_init"], jax_out["cli/loss"],
               rtol=C.CLI_LOSS_RTOL, atol=0.0)


def test_hybrid_cli_with_cp_on_the_host(results, capsys):
    """The CLI spawns its own 8 gloo ranks at ``--hybrid-mesh 2,1,2,2``
    and trains as the per-rank path does from the port's own init."""
    _, hist = launch_train.main([
        "--reduced", "--device", "cpu", "--hybrid-mesh", "2,1,2,2",
        "--microbatches", str(C.CLI["microbatches"]), "--steps",
        str(C.CLI["steps"]), "--batch", str(C.CLI["batch"]), "--seq",
        str(C.CLI["seq"])])
    out = capsys.readouterr().out
    assert "'ctx': 2" in out and "8 ranks" in out and "skipped_steps=0" in out
    assert [rec["loss"] for rec in hist] == results[0][0]["cli"]["own_init"]


# ---------------------------------------------------------------------------
# Host only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seq,heads,hd,chunk,cp,nbytes", [
    (1, 4096, 32, 128, 512, 1, 4),
    (4, 4096, 32, 128, 512, 4, 2),
    (2, 1000, 8, 64, 4096, 8, 4),
    (8, 32768, 64, 112, 512, 2, 2),
])
def test_working_set_matches_reference(batch, seq, heads, hd, chunk, cp,
                                       nbytes):
    """The bytes, the fitting budget's answer and the refusal text."""
    from repro.core import ring_attention as jra
    args = (batch, seq, heads, hd)
    kw = dict(chunk=chunk, cp=cp, dtype_bytes=nbytes)
    need = ra.attention_working_set_bytes(*args, **kw)
    assert need == jra.attention_working_set_bytes(*args, **kw)
    assert ra.check_attention_budget(need, *args, **kw) == need
    for budget in (need - 1, need // 3, 1):
        msgs = []
        for mod in (ra, jra):
            with pytest.raises(ValueError) as e:
                mod.check_attention_budget(budget, *args, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


class _FakeMesh:
    """A (data, pipe, ctx, model) = (1, 1, 2, 1) shape without a process
    group: the refusals come before any communication."""

    mesh_dim_names = ("data", "pipe", "ctx", "model")

    def size(self, i):
        return 2 if i == 2 else 1


def test_ssm_mixer_under_ctx_raises_in_stage_body():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    assert cfg.mixer_kind(0) == "ssm"
    pol = Policy.for_mesh(_FakeMesh())
    assert pol.active_ctx_axis == "ctx"
    pp = init_pipeline_params(cfg, torch.Generator().manual_seed(0), 1,
                              "cpu")
    stage = {k[6:]: v[0] for k, v in pp.items() if k.startswith("stage.")}
    x = torch.zeros(1, 8, cfg.d_model)
    pos = torch.arange(8)[None, :]
    with pytest.raises(NotImplementedError, match="zero state"):
        pipeline_stage_body(stage, x, cfg, pol, positions=pos)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-370m"])
def test_check_hybrid_refuses_ssm_mixers_under_cp(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(SystemExit, match="zero state"):
        launch_train.check_hybrid(cfg, (1, 1, 2, 1, 1))
    glm = reduced(get_config("glm4-9b"))
    launch_train.check_hybrid(glm, (1, 1, 2, 1, 1), seq=16)
    with pytest.raises(SystemExit, match="not divisible by CP=3"):
        launch_train.check_hybrid(glm, (1, 1, 3, 1, 1), seq=16)
    if arch == "jamba-v0.1-52b":
        launch_train.check_hybrid(cfg, (1, 1, 1, 1, 2))   # CP 1 is fine


def test_flash_head_dims_include_112():
    """kimi-k2-1t-a32b's head dim (64 heads of 112, 8 KV heads)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    kimi = get_config("kimi-k2-1t-a32b")
    assert kimi.resolved_head_dim == 112 and 112 in HEAD_DIMS


def test_one_hop_over_the_whole_sequence_is_blockwise():
    """One hop over the whole sequence (the ring at cp = 1) is the plain
    blockwise attention, within fp32 rounding."""
    from repro_torch.kernels.ref import blockwise_attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, 16, generator=g)
    carry = ra.ring_hop(ra.ring_init(q), q, k, v, q_pos0=0, kv_base=0,
                        chunk=16)
    torch.testing.assert_close(ra.ring_finish(carry, q.dtype),
                               blockwise_attention(q, k, v, chunk=16),
                               rtol=1e-6, atol=1e-6)

