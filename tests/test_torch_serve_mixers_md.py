"""The port's sharded serving of SSM mixers, MoE FFNs and K/V and query
head counts the model axis does not divide, against the JAX package: one
pool of 8 gloo ranks beside a child interpreter with 8 host devices
(``torch_serve_mixers_jax.py``) that runs the reference's engine with the
same policy on the same carried-over parameters (fp32, reduced configs).

- jamba at (data, model) = (2, 4) under ``kvdim`` and (4, 2) under
  ``kvseq``, mamba2 at (2, 4), kimi-k2 at (2, 4) under ``kvdim``,
  llama4-maverick at (4, 2) under ``kvseq``, glm4-9b at (2, 4) under
  both (2 K/V heads under TP 4), 12 query heads over 3 K/V heads at
  (4, 2), and at (2, 4) under both layouts 10 query heads over 5 (phi3)
  and 6 over 2 (phi4-mini), which TP 4 splits 3, 3, 2, 2 and 2, 2, 1, 1
  (the balanced decomposition): the prefill's last logits of each rank's
  rows within 1e-3 of scale and the 8 greedy tokens equal to the
  reference engine's with the same policy.  The reference's MoE capacity
  is per data replica, so at data > 1 it is held to that engine, not to
  one without a policy.
- ``init_rank_params`` draws the SSM and router leaves at
  ``init_params``' distributions (jamba, d_model widened to 256 for
  enough draws a rank).
- At (2, 3) and (1, 3), on 6 and 3 of the 8 ranks, where no width of
  the reduced configs divides by 3: glm4-9b under ``kvdim`` at (2, 3) and
  ``kvseq`` at (1, 3) (d_model 64, head_dim 16 and d_ff 128 split 22, 21,
  21 / 6, 5, 5 / 43, 43, 42; 4 query heads 2, 1, 1), mamba2 at (2, 3) (8
  SSM heads 3, 3, 2 and their d_inner channels), jamba and kimi-k2 with 6
  experts (kimi's shared expert d_ff 100), 12 query heads over 3 K/V
  heads at (2, 3) under ``kvdim`` (one K/V head a rank, head_dim 16 split
  6, 5, 5), and pixtral-12b at (2, 4) prefilled from the stub frontend's
  embeds: the same holds as above.
- Host only: ``check_serve_policy`` accepts these families at every TP
  their experts allow and refuses an expert count the model axis does not
  divide.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_region_cases as RC
import torch_serve_mixers_cases as C
from repro_torch.configs import get_config, reduced
from repro_torch.core import primitives as prim
from repro_torch.launch import mesh as tmesh
from repro_torch.models import (forward, init_cache, init_rank_params,
                                shard_params)
from repro_torch.models.blocks import check_serve_policy
from repro_torch.serve import ServeEngine
from repro_torch.sharding import Policy

POOL_TIMEOUT_S = 600
# jamba with d_model 256: 32 SSM heads (8 a rank at TP 4) a layer
INIT_CFG = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                               d_model=256)
INIT_LEAVES = ("a_log", "d_skip", "dt_bias", "ssm_norm", "router", "conv_w",
               "in_B", "in_dt")


def _init_draws(cfg):
    """This rank's draws of the leaves ``INIT_LEAVES`` names, concatenated
    over the layers, with their dtypes and global second-last dims."""
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    mine = init_rank_params(cfg, Policy.for_mesh(mesh), seed=5,
                            device="cpu")
    out = {}
    for name in INIT_LEAVES:
        keys = sorted(k for k in mine if k.rsplit(".", 1)[-1] == name)
        out[name] = {"values": torch.cat([mine[k].reshape(-1).double()
                                          for k in keys]).numpy(),
                     "dtypes": {str(mine[k].dtype) for k in keys}}
    return out


@torch.inference_mode()
def _serve_embeds(eng, emb):
    """The sharded engine's prefill from the stub frontend's ``emb`` (the
    global batch; ``ServeEngine.prefill`` takes tokens, as the
    reference's), then STEPS greedy decode steps: (this rank's last
    prefill logits, the global greedy tokens)."""
    cfg, pol = eng.cfg, eng.policy
    cache = init_cache(cfg, C.BATCH, C.MAX_SEQ, device="cpu", policy=pol)
    logits, cache, _ = forward(eng.params, {"embeds": eng._rows(emb)}, cfg,
                               mode="prefill", cache=cache, policy=pol)
    first = logits = logits[:, -1]
    tokens = []
    for t in range(C.STEPS):
        tokens.append(logits.argmax(-1, keepdim=True))
        logits, cache = eng.decode_step(cache, tokens[-1], C.PROMPT + t)
    with prim.use_mesh(pol.mesh):
        return first, prim.all_gather(torch.cat(tokens, 1), "data", 0)


def _rank_fn(rank, mesh1d, init):
    prompt = torch.from_numpy(init["prompt"]).long()
    out = {}
    for case, (model, shape, layout) in C.CASES.items():
        cfg = C.model_config(model, get_config, reduced)
        params = {k[len(model) + 1:]: torch.from_numpy(v)
                  for k, v in init.items() if k.startswith(f"{model}/")}
        mesh = tmesh.make_host_mesh(shape, ("data", "model"), device="cpu")
        if mesh is None:    # a (2, 3) mesh: ranks 6 and 7 sit it out
            continue
        pol = Policy.for_mesh(mesh, kv_layout=layout)
        eng = ServeEngine(cfg, shard_params(cfg, params, pol), pol,
                          max_seq=C.MAX_SEQ, batch_size=C.BATCH)
        with prim.use_mesh(mesh):
            row = prim.axis_index("data")
        if case in C.EMBEDS:
            logits, tokens = _serve_embeds(
                eng, torch.from_numpy(C.embeds(cfg.d_model, np)))
        else:
            logits, _ = eng.prefill(prompt)
            tokens = eng.generate(prompt, steps=C.STEPS)
        out[case] = {"logits": logits, "row": row, "tokens": tokens}
    out["init"] = _init_draws(INIT_CFG)
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "serve_mixers.npz"
    child = C.start_jax(path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, jax_out


def _serving(ranks, case):
    """The ranks of ``case``'s mesh (the first data x model), and that no
    other rank served it."""
    shape = C.CASES[case][1]
    world = shape[0] * shape[1]
    assert all(case not in rank for rank in ranks[world:]), case
    return ranks[:world]


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_prefill_logits_match_reference(results, case):
    ranks, jax_out = results
    want = jax_out[f"{case}/logits"]
    dp = C.CASES[case][1][0]
    b = C.BATCH // dp
    scale = float(np.abs(want).max())
    for r, rank in enumerate(_serving(ranks, case)):
        got = rank[case]
        rows = want[got["row"] * b:(got["row"] + 1) * b]
        np.testing.assert_allclose(got["logits"], rows, rtol=0,
                                   atol=C.LOGITS_TOL * scale,
                                   err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_greedy_tokens_equal_reference(results, case):
    ranks, jax_out = results
    want = jax_out[f"{case}/tokens"]
    for r, rank in enumerate(_serving(ranks, case)):
        np.testing.assert_array_equal(rank[case]["tokens"], want,
                                      err_msg=f"{case} rank {r}")


def _pooled(ranks, name):
    """A leaf's draws over the model ranks of data replica 0 (the other
    replica holds the same shards, or the same whole leaf)."""
    return [rank["init"][name] for rank in ranks[:4]]


@pytest.mark.parametrize("name", INIT_LEAVES)
def test_rank_initialiser_draws_ssm_and_router_leaves(results, name):
    """``init_rank_params`` draws each SSM and router leaf as
    ``init_params`` does (``ssm_init``, ``moe_init``): the per-head and
    per-channel vectors in fp32 (a_log uniform in [0, log 16), d_skip and
    ssm_norm ones, dt_bias zeros), the router N(0, 1/d) in fp32, conv_w
    N(0, 1/k), in_B and in_dt N(0, 1/d) in the model's dtype; each data
    replica holds the same draws."""
    ranks, _ = results
    cfg = INIT_CFG
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["init"][name]["values"],
                                      ranks[r % 4]["init"][name]["values"])
    parts = _pooled(ranks, name)
    assert all(p["dtypes"] == {"torch.float32"} for p in parts), parts
    vals = np.concatenate([p["values"] for p in parts])
    if name in ("d_skip", "ssm_norm", "dt_bias"):
        np.testing.assert_array_equal(vals, float(name != "dt_bias"))
        return
    if name == "a_log":
        assert vals.min() >= 0 and vals.max() < math.log(16.0), vals
        # uniform: mean log(16)/2, std log(16)/sqrt(12); 128 draws
        assert abs(vals.mean() / (math.log(16.0) / 2) - 1) < 0.15, vals
        assert abs(vals.std() / (math.log(16.0) / 12 ** 0.5) - 1) < 0.2
        return
    d_in = {"conv_w": cfg.conv_kernel}.get(name, cfg.d_model)
    assert abs(vals.mean()) < 0.1 * d_in ** -0.5, (name, vals.mean())
    assert abs(vals.std() / d_in ** -0.5 - 1) < 0.1, (name, vals.std())
    if name in ("router", "in_B"):
        # whole: the same on every rank
        assert all(np.array_equal(p["values"], parts[0]["values"])
                   for p in parts)
    else:
        assert len({p["values"].tobytes() for p in parts}) == 4


class _FakeMesh:
    """A mesh shape without a process group: the checks come before any
    communication."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape[i]


def _policy(shape, **kw):
    return Policy.for_mesh(_FakeMesh(shape), **kw)


@pytest.mark.parametrize("arch,tp", [
    ("jamba-v0.1-52b", 4), ("kimi-k2-1t-a32b", 4), ("mamba2-370m", 4),
    ("llama4-maverick-400b-a17b", 4), ("glm4-9b", 4), ("phi3-medium-14b", 4),
    # query heads TP 16 does not divide: 40, 40, 24 and 24
    ("llama4-maverick-400b-a17b", 16), ("phi3-medium-14b", 16),
    ("phi4-mini-3.8b", 16), ("musicgen-medium", 16),
    # widths the model axis does not divide, split by the balanced
    # decomposition: mamba2's 32 SSM heads and d_inner 2048 at 3; glm4's
    # d_model 4096, head_dim 128 and d_ff 13696 at 3; kimi's d_model 7168
    # and shared expert d_ff 2048 at 6 (its 384 experts divide)
    ("mamba2-370m", 3), ("glm4-9b", 3), ("kimi-k2-1t-a32b", 6),
])
@pytest.mark.parametrize("layout", ["kvdim", "kvseq"])
def test_serving_accepts_the_full_width_families(arch, tp, layout):
    check_serve_policy(get_config(arch), _policy((1, tp), kv_layout=layout))


@pytest.mark.parametrize("arch,tp,match", [
    ("jamba-v0.1-52b", 32, "num_experts"),  # 16 experts
    ("kimi-k2-1t-a32b", 7, "num_experts"),  # 384 experts
])
def test_serving_refuses_widths_the_model_axis_does_not_divide(arch, tp,
                                                               match):
    """Only an expert count the model axis does not divide is refused, as
    the reference's expert split refuses it."""
    with pytest.raises(NotImplementedError, match=match):
        check_serve_policy(get_config(arch), _policy((1, tp)))
