"""The inputs are a function of ``--seed`` alone: the same seed gives the
same token stream, prompts and weights, another seed other ones, and the
driver's large seeds work."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from reference import inputs  # noqa: E402

TINY = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 8, "d_ff": 48, "vocab_size": 97, "dtype": "bfloat16",
        "tie_embeddings": False}
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_stream_is_the_seeds(seed):
    a = inputs.train_batch(seed, 3, 4, 64, 1000)
    b = inputs.train_batch(seed, 3, 4, 64, 1000)
    other = inputs.train_batch(seed + 1, 3, 4, 64, 1000)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["tokens"], other["tokens"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 1000


def test_train_rows_all_differ():
    rows = np.concatenate([inputs.train_batch(5, i, 4, 32, 50000)["tokens"]
                           for i in range(6)])
    assert len({r.tobytes() for r in rows}) == len(rows)


@pytest.mark.parametrize("seed", SEEDS)
def test_prompts_are_the_seeds(seed):
    a = inputs.prompts(seed, 4, 2, 16, 500)
    assert np.array_equal(a, inputs.prompts(seed, 4, 2, 16, 500))
    assert not np.array_equal(a, inputs.prompts(seed, 5, 2, 16, 500))
    assert not np.array_equal(a, inputs.prompts(seed, -1, 2, 16, 500))
    assert a.shape == (2, 16) and 0 <= a.min() and a.max() < 500


@pytest.mark.parametrize("seed", SEEDS[1:3])
def test_weights_are_the_seeds_leaf_by_leaf(seed):
    w = inputs.make_weights(TINY, seed, "cpu")
    assert set(w) == set(inputs.leaf_specs(TINY))
    for name, t in w.items():
        again = inputs.make_leaf(TINY, name, seed, "cpu")
        assert torch.equal(t, again), name
    assert w["blocks.pos0.attn.wq"].dtype == torch.bfloat16
    assert w["norm_final"].dtype == torch.float32
    other = inputs.make_leaf(TINY, "embed", seed + 1, "cpu")
    assert not torch.equal(w["embed"], other)
    assert not torch.equal(w["blocks.pos0.mlp.w_up"],
                           w["blocks.pos0.mlp.w_gate"])


def test_weight_scales():
    w = inputs.make_leaf(dict(TINY, d_model=256, d_ff=1024), "blocks.pos0."
                         "mlp.w_down", 3, "cpu").float()
    assert abs(float(w.std()) - 1 / 32) < 2e-3
