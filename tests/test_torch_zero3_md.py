"""The port's policy train program (``repro_torch.train.build_train_step(cfg,
opt, policy=Policy(mesh))``: ZeRO-3 over ``data``, tensor and sequence
parallelism over ``model``) against the JAX package's GSPMD
``build_train_step(cfg, Policy(mesh), opt)``, on one pool of 8 gloo ranks
beside three child interpreters with 8 host devices each
(``torch_zero3_jax.py``) running the reference on the same carried-over
parameters and batches (fp32).  The reference runs each arch on (2, 4):
its GSPMD step's values are global, the same on every mesh to fp32
rounding (``torch_zero3_cases.REFERENCE``).

- reduced glm4-9b (4 query heads, 2 K/V heads: model = 4 does not divide
  them) at (data, model) = (2, 4), (4, 2) and (8, 1): the loss and grad
  norm of two steps, every global gradient leaf gathered from the blocks,
  and the params and both moments after two AdamW steps.
- reduced kimi-k2 (MoE, Adafactor) cut to one block period, and reduced
  mamba2-370m (SSM, tied embeddings), at (2, 4): losses, grad norms and
  the state after two steps.
- reduced glm4-9b with 6 query heads, which model = 4 does not divide
  (wq's columns split mid-head by the reference's spec, each rank
  attending its balanced block of heads), at (2, 4): losses, grad norms,
  every gradient leaf and the state after two steps.
- reduced glm4-9b at ``grad_accum=2`` at (2, 4), and reduced mamba2-370m
  at (2, 3) on 6 of the 8 ranks (8 SSM heads, d_inner 128 and the
  sequence 16, none divisible by 3: the SSM leaves whole over model, each
  rank's heads and sequence block the balanced split), and kimi-k2's
  period with 6 experts at (2, 3) (each rank routes the whole sequence
  16, which 3 does not divide): losses, grad norms, every gradient leaf
  and the state after two steps.
- ZeRO-3 holds: each rank's block of each leaf is 1 / (the size of the
  axes its spec names) of it, and so are its moments.
- the sharded state saved and restored bitwise, and the same checkpoint
  restored into the one-device path (the format is global).
- ``launch.train --reduced --device cpu --world 8 --steps 3``'s ranks end
  on the loss of ``--world 1``, and ``--world 8`` spawns them.
"""

import contextlib
import functools
import io
import math
import os
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_region_cases as RC
import torch_zero3_cases as C
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import linop
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models.attention import head_block, local_kv_heads
from repro_torch.models.blocks import check_train_policy
from repro_torch.models.model import shard_train_params
from repro_torch.optim import make_optimizer
from repro_torch.sharding import Policy
from repro_torch.sharding.policy import _PARAM_RULES
from repro_torch.train import build_train_step, init_train_state
from repro_torch.train.step import sp_state_parts

POOL_TIMEOUT_S = 600


def config(model):
    return C.model_config(model, get_config, reduced)


def _flat_state(state) -> dict:
    """``{"params/<k>", "m/<k>", "v/<k>[.vr|.vc|.v]"}`` of a train state."""
    out = {f"params/{k}": v for k, v in state["params"].items()}
    out.update({f"m/{k}": v for k, v in state["opt"]["m"].items()})
    for k, v in state["opt"]["v"].items():
        if isinstance(v, dict):
            out.update({f"v/{k}.{s}": t for s, t in v.items()})
        else:
            out[f"v/{k}"] = v
    return out


def _spec_of(key, parts):
    return parts[key.split("/", 1)[1]]


def _case(case, init, ckpt_dir):
    arch, shape = C.CASES[case]
    cfg = config(arch)
    params = {k[len(arch) + 1:]: torch.from_numpy(v)
              for k, v in init.items() if k.startswith(f"{arch}/")}
    mesh = tmesh.make_host_mesh(shape, device="cpu", all_ranks_group=True)
    if mesh is None:    # a (2, 3) mesh: ranks 6 and 7 sit it out
        return None
    pol = Policy(mesh)
    opt = make_optimizer(cfg.optimizer, total_steps=C.TOTAL_STEPS,
                         base_lr=C.LR)
    grads = {}

    def capture(g):
        if not grads:
            grads.update({k: v.clone() for k, v in g.items()})
        return g

    step = build_train_step(cfg, opt, policy=pol, fault_hook=capture)
    state = init_train_state(cfg, shard_train_params(cfg, params, pol), opt)
    mets = []
    for b in C.batches(cfg.vocab_size):
        state, met = step(state, b)
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm",
                                                "skipped")})
    parts = sp_state_parts(cfg, pol, opt)
    flat = _flat_state(state)
    me = dist.get_rank() == 0
    out = {"mets": mets, "count": state["opt"]["count"],
           # each block's shape against its global leaf's and the sizes of
           # the axes its spec names
           "blocks": {k: (tuple(v.shape), [
               [pol.axis_size(a) for a in
                ((e,) if isinstance(e, str) else e or ())]
               for e in _spec_of(k, parts)]) for k, v in flat.items()}}
    with torch.no_grad():
        whole = {k: linop.assemble(v, _spec_of(k, parts), mesh)
                 for k, v in flat.items()}
        g = {k: linop.assemble(v, parts[k], mesh) for k, v in grads.items()}
    if me:
        out["state"] = {k: v.float() for k, v in whole.items()}
        out["bf16"] = sorted(k for k, v in whole.items()
                             if v.dtype == torch.bfloat16)
        out["grads"] = g
        out["global_shapes"] = {k: tuple(v.shape) for k, v in whole.items()}
    if case == C.CKPT_CASE:
        ckpt.save(ckpt_dir, 2, state, policy=pol, parts=parts)
        back, _ = ckpt.restore(ckpt_dir, like=state, policy=pol, parts=parts)
        out["ckpt_bitwise"] = all(
            torch.equal(a, b) for a, b in zip(_flat_state(back).values(),
                                              flat.values()))
        dist.barrier()
        if me:
            # the one-device path: a global state restores the same file
            like = init_train_state(cfg, params, opt)
            one, _ = ckpt.restore(ckpt_dir, like=like)
            out["ckpt_one_device"] = all(
                torch.equal(v, whole[k]) for k, v in _flat_state(one).items())
        dist.barrier()
    return out


def _rank_fn(rank, mesh1d, paths, ckpt_dir):
    cli = launch_train._sp_rank_main(
        rank, mesh1d, cfg=reduced(get_config("glm4-9b")), world=8,
        **CLI_RUN)
    init = {}
    for path in paths.values():
        # the JAX children write their parameters first
        deadline = time.monotonic() + POOL_TIMEOUT_S
        while not os.path.exists(RC.params_path(path)):
            assert time.monotonic() < deadline, f"no {path}"
            time.sleep(0.2)
        with np.load(RC.params_path(path)) as data:
            init.update(data)
    out = {case: _case(case, init, ckpt_dir) for case in C.CASES}
    out = {case: o for case, o in out.items() if o is not None}
    dist.barrier()
    if rank:
        out = {case: {"blocks": o["blocks"]} for case, o in out.items()}
    out["cli"] = cli["history"][-1]["loss"]
    return out


# ``launch.train --reduced --device cpu --steps 3``'s run (its defaults):
# ``--world 8`` spawns 8 ranks that each run ``_sp_rank_main`` with these,
# which the pool runs itself (one 8-rank spawn serves both)
CLI_ARGV = ["--reduced", "--device", "cpu", "--steps", "3"]
CLI_RUN = dict(steps=3, batch=8, seq=128, lr=1e-3, seed=0, device="cpu",
               max_restarts=3, rollback_after_skips=None, ckpt_dir=None,
               ckpt_every=50, fault_plan=None)


def _cli_world1_loss() -> float:
    """``launch.train ... --world 1``'s final loss (the one-device path),
    read from the ``done:`` line it prints; on one intra-op thread, as
    the ranks (its ops are small, and the JAX children compile beside
    it)."""
    buf, threads = io.StringIO(), torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            launch_train.main(CLI_ARGV + ["--world", "1"])
    finally:
        torch.set_num_threads(threads)
    return float(re.search(r"done: final loss ([-0-9.e+]+)",
                           buf.getvalue()).group(1))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "zero3"
    children = {w: C.start_jax(out, w) for w in C.CHILDREN}
    paths = {w: C.child_path(out, w) for w in C.CHILDREN}
    try:
        # the one-device CLI and the pool run while the JAX children draw
        # and compile
        cli = _cli_world1_loss()
        ranks = tmesh.spawn(
            functools.partial(_rank_fn, paths=paths,
                              ckpt_dir=str(tmp_path_factory.mktemp("ck"))),
            8, device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = {}
        for w, proc in children.items():
            jax_out.update(RC.finish_jax(proc, paths[w]))
    return ranks, jax_out, cli


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_losses_and_grad_norms_match_reference(results, case):
    ranks, want, _ = results
    ref = C.REFERENCE[case]
    for i, met in enumerate(ranks[0][case]["mets"], start=1):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(
                met[key], want[f"{ref}/step{i}/{key}"], rtol=C.LOSS_RTOL,
                err_msg=f"{case} step {i} {key}")
        assert met["skipped"] == want[f"{ref}/step{i}/skipped"] == 0


@pytest.mark.parametrize("case", [c for c in sorted(C.CASES)
                                  if C.REFERENCE[c] in C.GRADS_CASES])
def test_global_grads_match_reference(results, case):
    """Every gradient leaf of the first step, gathered from the blocks,
    against the reference's on (2, 4) (its gradients are global values)."""
    ranks, want, _ = results
    ref = C.REFERENCE[case]
    np.testing.assert_allclose(ranks[0][case]["mets"][0]["loss"],
                               want[f"{ref}/loss"], rtol=C.LOSS_RTOL)
    got = ranks[0][case]["grads"]
    keys = {k.split("/", 2)[2] for k in want
            if k.startswith(f"{ref}/grads/")}
    assert keys == set(got)
    for k in sorted(keys):
        np.testing.assert_allclose(got[k], want[f"{ref}/grads/{k}"],
                                   rtol=C.GRAD_TOL, atol=C.GRAD_TOL,
                                   err_msg=f"{case} grad {k}")


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_state_after_two_steps_matches_reference(results, case):
    """Params and both moments (Adafactor's factored statistics too); a
    moment stored in bf16 (Adafactor's m) may differ by one bf16 rounding,
    as in ``tests/test_torch_train.py``."""
    ranks, want, _ = results
    ref = C.REFERENCE[case]
    got = ranks[0][case]
    assert got["count"] == int(want[f"{ref}/count"]) == 2
    keys = {k.split("/", 1)[1] for k in want
            if re.match(rf"{ref}/(params|m|v)/", k)}
    assert keys == set(got["state"])
    for k in sorted(keys):
        tol = 2 ** -8 if k in got["bf16"] else C.GRAD_TOL
        np.testing.assert_allclose(got["state"][k],
                                   want[f"{ref}/{k}"], rtol=tol, atol=tol,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_every_rank_holds_zero3_blocks(results, case):
    """Each rank's block of every parameter and moment is its global leaf
    cut by the sizes of the axes its spec names, and every parameter and
    moment whose ``fsdp`` dim (the reference's rules) the data axis
    divides is cut over it: 1 / dp of that dim on every rank."""
    ranks, _, _ = results
    shapes = ranks[0][case]["global_shapes"]
    dp, tp = C.CASES[case][1]
    assert [case in rank for rank in ranks] == (
        [True] * (dp * tp) + [False] * (8 - dp * tp))
    cut = 0
    for r, rank in enumerate(ranks[:dp * tp]):
        for k, (local, sizes) in rank[case]["blocks"].items():
            want = tuple(n // math.prod(s) for n, s in zip(shapes[k], sizes))
            assert local == want, (r, k, local, shapes[k], sizes)
            name = k.split("/", 1)[1]
            rule = _PARAM_RULES.get(name.rsplit(".", 1)[-1], ())
            if "fsdp" not in rule or not k.startswith(("params/", "m/")):
                continue
            d = rule.index("fsdp") + name.startswith("blocks.")
            if shapes[k][d] % dp == 0:
                assert local[d] == shapes[k][d] // dp, (r, k, local)
                cut += 1
    assert cut


def test_checkpoint_round_trip_and_one_device_restore(results):
    ranks, _, _ = results
    got = ranks[0][C.CKPT_CASE]
    assert got["ckpt_bitwise"]
    assert got["ckpt_one_device"]


def test_cli_world8_ends_on_world1_losses(results):
    """``launch.train --reduced --device cpu --world 8 --steps 3``'s ranks
    (``_sp_rank_main`` on mesh (8, 1), run by the pool) end on ``--world
    1``'s loss (the one-device path)."""
    ranks, _, world1 = results
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["cli"], world1, rtol=2e-5,
                                   err_msg=f"rank {r}")


def test_cli_world_spawns_the_policy_program(monkeypatch, capsys):
    """``--world 8`` (no ``--hybrid-mesh``) spawns ``train_sp`` on 8 ranks
    with the CLI's run and prints rank 0's ``done:`` line on the mesh."""
    calls = []

    def fake_train_sp(cfg, world, **kw):
        calls.append((cfg.name, world, kw))
        hist = launch_train.train(cfg, **kw)[1]
        return [{"history": list(hist), "health": hist.health, "log": []}]

    monkeypatch.setattr(launch_train, "train_sp", fake_train_sp)
    launch_train.main(CLI_ARGV + ["--world", "8", "--steps", "1"])
    (name, world, kw), = calls
    assert (name, world) == ("glm4-9b", 8)
    assert kw == dict(CLI_RUN, steps=1)
    assert "(8, 1), 8 ranks" in capsys.readouterr().out


class _FakeMesh:
    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("arch,heads", [("phi4-mini-3.8b", 24),
                                        ("phi3-medium-14b", 40),
                                        ("musicgen-medium", 24),
                                        ("llama4-maverick-400b-a17b", 40)])
def test_query_heads_the_model_axis_does_not_divide_are_refused(arch, heads):
    """The policy train program takes query heads the model axis does not
    divide: at (16, 16) each rank's block of heads is the balanced split
    (the first H % 16 ranks one head more, the blocks consecutive), and
    the K/V heads each rank takes give every query head its own group's
    K/V head under the GQA grouping of ``ops.flash_attention``."""
    cfg = get_config(arch)
    assert cfg.num_heads == heads
    check_train_policy(cfg, Policy(_FakeMesh((16, 16))))
    check_train_policy(get_config("glm4-9b"), Policy(_FakeMesh((16, 16))))
    group = cfg.num_heads // cfg.num_kv_heads
    nxt = 0
    for r in range(16):
        first, n = head_block(heads, 16, r)
        assert first == nxt and n == heads // 16 + (r < heads % 16)
        nxt = first + n
        kv = local_kv_heads(cfg, 16, r)
        assert n % len(kv) == 0
        for j in range(n):
            assert kv[j // (n // len(kv))] == (first + j) // group, (r, j)
    assert nxt == heads


def test_other_axes_and_no_seq_shard_are_refused():
    cfg = reduced(get_config("glm4-9b"))
    with pytest.raises(ValueError, match="ctx"):
        check_train_policy(cfg, Policy(_FakeMesh((2, 2, 2),
                                                 ("data", "ctx", "model"))))
    with pytest.raises(ValueError, match="seq_shard"):
        check_train_policy(cfg, Policy(_FakeMesh((2, 2)), seq_shard=False))


def test_uneven_ssm_widths_train_and_uneven_experts_are_refused():
    """The policy train program takes mamba2-370m's 32 SSM heads and
    d_inner 2048 at (16, 3) (each rank its balanced block of 11, 11 or 10
    heads and their channels of the whole leaves), and refuses an expert
    count the model axis does not divide, as the reference's expert split
    does: jamba's 16 experts at 3."""
    check_train_policy(get_config("mamba2-370m"),
                       Policy(_FakeMesh((16, 3))))
    with pytest.raises(NotImplementedError, match="'num_experts': 16"):
        check_train_policy(get_config("jamba-v0.1-52b"),
                           Policy(_FakeMesh((16, 3))))
