"""The port's sharded serving (``ServeEngine(cfg, params, policy)`` over a
(data, model) mesh, the cache under ``kvdim`` and ``kvseq``) against the
JAX package, on one pool of 8 gloo ranks beside a child interpreter with 8
host devices (``torch_serve_jax.py``) that runs the reference's engine
with the same policy on the same carried-over parameters of reduced
mistral-large-123b (fp32).

- (data, model) = (2, 4) and (4, 2) under each layout, and (2, 4) under
  ``kvseq`` with a max_seq the model axis does not divide: the prefill's
  last logits of each rank's rows within 1e-3 of scale and the 8 greedy
  tokens equal to the reference engine's with the same policy (which
  equal its tokens without one).
- each rank's parameters come from ``shard_params`` (the global tree cut
  leaf by leaf); ``init_rank_params`` gives the same shapes, the whole
  leaves the same on every rank and each split leaf the same across the
  data replicas, and serves finite logits.
- ``init_rank_params`` draws ``init_params``' leaves at its
  distributions (N(0, 1/d_in) of the global leaf, unit norm weights).
- Host only: the refusals (widths the model axis does not divide, SSM
  heads and experts among them; axes besides data and model).
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_region_cases as RC
import torch_serve_cases as C
from repro_torch.configs import get_config, reduced
from repro_torch.core import primitives as prim
from repro_torch.launch import mesh as tmesh
from repro_torch.models import init_rank_params, shard_params
from repro_torch.models.blocks import check_serve_policy
from repro_torch.serve import ServeEngine
from repro_torch.sharding import Policy

CFG = reduced(get_config(C.ARCH))
POOL_TIMEOUT_S = 600


def _rank_fn(rank, mesh1d, init):
    params = {k[len("params/"):]: torch.from_numpy(v)
              for k, v in init.items() if k.startswith("params/")}
    prompt = torch.from_numpy(init["prompt"]).long()
    out = {}
    for case, (shape, layout, max_seq) in C.CASES.items():
        mesh = tmesh.make_host_mesh(shape, ("data", "model"), device="cpu")
        pol = Policy.for_mesh(mesh, kv_layout=layout)
        eng = ServeEngine(CFG, shard_params(CFG, params, pol), pol,
                          max_seq=max_seq, batch_size=C.BATCH)
        logits, _ = eng.prefill(prompt)
        with prim.use_mesh(mesh):
            row = prim.axis_index("data")
        out[case] = {"logits": logits, "row": row,
                     "tokens": eng.generate(prompt, steps=C.STEPS)}
    # the per-rank initialiser on (2, 4)
    mesh = tmesh.make_host_mesh((2, 4), ("data", "model"), device="cpu")
    pol = Policy.for_mesh(mesh, kv_layout="kvseq")
    mine = init_rank_params(CFG, pol, seed=3, device="cpu")
    cut = shard_params(CFG, params, pol)
    eng = ServeEngine(CFG, mine, pol, max_seq=C.MAX_SEQ, batch_size=C.BATCH)
    logits, _ = eng.prefill(prompt)
    out["init"] = {
        "shapes": {k: tuple(v.shape) for k, v in mine.items()},
        "cut_shapes": {k: tuple(v.shape) for k, v in cut.items()},
        "sums": {k: float(v.double().sum()) for k, v in mine.items()},
        "keys": sorted(mine) == sorted(params),
        # each leaf's std against N(0, 1/d_in) of the GLOBAL leaf, or
        # whether it is the unit fp32 norm weight
        "stds": {k: (float(v.double().std()),
                     float(params[k].shape[-2]) ** -0.5)
                 for k, v in mine.items() if "norm" not in k},
        "norms": {k: v.dtype == torch.float32 and bool((v == 1).all())
                  for k, v in mine.items() if "norm" in k},
        "finite": bool(torch.isfinite(logits).all())}
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "serve.npz"
    child = C.start_jax(path)
    try:
        init = RC.wait_params(child, path)
        ranks = tmesh.spawn(functools.partial(_rank_fn, init=init), 8,
                            device="cpu", timeout_s=POOL_TIMEOUT_S)
    finally:
        jax_out = RC.finish_jax(child, path)
    return ranks, jax_out


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_prefill_logits_match_reference(results, case):
    ranks, jax_out = results
    want = jax_out[f"{case}/logits"]
    dp = C.CASES[case][0][0]
    b = C.BATCH // dp
    scale = float(np.abs(want).max())
    for r, rank in enumerate(ranks):
        got = rank[case]
        rows = want[got["row"] * b:(got["row"] + 1) * b]
        np.testing.assert_allclose(got["logits"], rows, rtol=0,
                                   atol=C.LOGITS_TOL * scale,
                                   err_msg=f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_greedy_tokens_equal_reference(results, case):
    ranks, jax_out = results
    want = jax_out[f"{case}/tokens"]
    np.testing.assert_array_equal(want, jax_out["none/tokens"])
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank[case]["tokens"], want,
                                      err_msg=f"{case} rank {r}")


def test_rank_initialiser_holds_this_ranks_shards(results):
    ranks, _ = results
    for r, rank in enumerate(ranks):
        got = rank["init"]
        assert got["shapes"] == got["cut_shapes"], r
        assert got["finite"], r
    tp = 4
    for key in ranks[0]["init"]["sums"]:
        sums = [rank["init"]["sums"][key] for rank in ranks]
        if key.startswith("blocks.") and "norm" not in key:
            # split: the same across the data replicas, not across model
            assert sums[:tp] == sums[tp:], key
            assert len(set(sums[:tp])) == tp, key
        else:
            assert len(set(sums)) == 1, key


@pytest.mark.parametrize("kind", ["whole", "split", "norm"])
def test_rank_initialiser_draws_init_params_leaves(results, kind):
    """``init_rank_params`` draws ``init_params``' leaves: the same keys,
    the whole leaves (embedding, head) and this rank's blocks of the split
    ones at N(0, 1/d_in) with the global leaf's d_in (wo's and w_down's
    row blocks too), the norm weights ones in fp32."""
    ranks, _ = results
    for r, rank in enumerate(ranks):
        got = rank["init"]
        assert got["keys"], r
        if kind == "norm":
            assert got["norms"] and all(got["norms"].values()), (r, got)
            continue
        stds = {k: v for k, v in got["stds"].items()
                if k.startswith("blocks.") == (kind == "split")}
        assert stds, (r, kind)
        for k, (std, want) in stds.items():
            assert abs(std / want - 1) < 0.1, (r, k, std, want)


class _FakeMesh:
    """A mesh shape without a process group: the refusals come before any
    communication."""

    def __init__(self, shape, names=("data", "model")):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape[i]


def _policy(shape, names=("data", "model"), **kw):
    return Policy.for_mesh(_FakeMesh(shape, names), **kw)


@pytest.mark.parametrize("arch,tp,match", [
    ("mamba2-370m", 16, None),             # SSM mixers: 8 heads, served
    ("jamba-v0.1-52b", 8, "num_experts"),  # SSM mixers and MoE FFNs
    ("kimi-k2-1t-a32b", 8, "num_experts"),  # MoE FFNs: 4 experts
])
def test_serving_refuses_ssm_and_moe(arch, tp, match):
    """SSM mixers and MoE FFNs are served (``test_torch_serve_mixers_md``
    holds them to the reference); refused only where the model axis does
    not divide their experts, as the reference refuses them.  SSM heads
    the axis does not divide split by the balanced decomposition."""
    cfg = reduced(get_config(arch))
    check_serve_policy(cfg, _policy((2, 2)))
    check_serve_policy(cfg, _policy((2, 4)))
    if match is None:
        check_serve_policy(cfg, _policy((1, tp)))
        return
    with pytest.raises(NotImplementedError, match=match):
        check_serve_policy(cfg, _policy((1, tp)))


def test_serving_refuses_heads_the_model_axis_does_not_divide():
    """Query heads and widths the model axis does not divide are served
    (split by the balanced decomposition), none refused: reduced mistral
    at TP 3 (d_model 64, 4 heads, head_dim 16) under both layouts and
    at TP 32 under ``kvdim`` (head_dim 16 over 32), and the four archs
    whose heads 16 does not divide at (16, 16)."""
    for layout in ("kvdim", "kvseq"):
        check_serve_policy(CFG, _policy((1, 3), kv_layout=layout))
    for arch in ("llama4-maverick-400b-a17b", "phi3-medium-14b",
                 "phi4-mini-3.8b", "musicgen-medium"):
        check_serve_policy(get_config(arch), _policy((16, 16)))
    # glm4-9b has 2 kv heads: TP 2 and TP 4 serve it (wk, wv whole at 4)
    glm = get_config("glm4-9b")
    check_serve_policy(glm, _policy((1, 2)))
    check_serve_policy(glm, _policy((1, 4)))
    check_serve_policy(CFG, _policy((1, 32), kv_layout="kvdim"))


def test_serving_refuses_other_axes_and_layouts():
    with pytest.raises(ValueError, match="data, model"):
        check_serve_policy(CFG, _policy((2, 2, 2), ("data", "ctx", "model")))
    with pytest.raises(ValueError, match="kv_layout"):
        check_serve_policy(CFG, _policy((1, 2), kv_layout="kvboth"))
    with pytest.raises(NotImplementedError, match="num_experts"):
        ServeEngine(reduced(get_config("jamba-v0.1-52b")), {"embed":
                    torch.zeros(1)}, _policy((1, 16)), max_seq=8,
                    batch_size=2)
