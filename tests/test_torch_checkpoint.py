"""The port's checkpoints (``repro_torch/checkpoint/ckpt.py``) against the
JAX package's.

- Every case of ``tests/test_checkpoint.py``, port against port: round
  trip, async save, shape and dtype refusals, async errors re-raised, the
  pending list pruned, bit flips and truncation caught, fallback with
  quarantine, a manifest-less directory skipped, an unreadable manifest
  corrupt, and the cross-mesh restore on 4 gloo ranks (plain restore
  refused with ``MeshMismatchError``, ``restore_resharded`` landing each
  rank's block).
- The on-disk format: a reduced glm4-9b fp32 train state after two steps,
  saved by each package, gives the same files byte for byte, and the
  port's key paths are the reference manifest's, in its order.
- JAX -> port: the reference's checkpoint restores in the port leaf for
  leaf, bitwise against ``params_from_jax``, and the port's next step then
  matches the reference's at 1e-4 (``tests/test_torch_train.py``'s pin).
- Port -> JAX: the port's checkpoint restores under the reference's
  ``ckpt.restore(like=...)`` bitwise.
- The bf16 caveat: a bf16 leaf the reference wrote restores in the port
  as bf16, bitwise, while the reference's own restore refuses it.
"""

import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import train as jtrain
from repro.checkpoint import ckpt as jckpt
from repro.models import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import configs, train
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.linop import PartitionSpec as P
from repro_torch.launch import mesh as tmesh
from repro_torch.models.convert import flatten, params_from_jax
from repro_torch.optim import make_optimizer
from repro_torch.resilience import corrupt_checkpoint
from repro_torch.sharding import Policy

TOL = 1e-4


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "blocks.pos0.wq": torch.randn(4, 8, 6, generator=g)},
            "step": 7}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal(a[k], b[k])
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, port against port
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    s = _state()
    ckpt_lib.save(str(tmp_path), 7, s)
    restored, step = ckpt_lib.restore(str(tmp_path), like=_state(1))
    assert step == 7
    _equal(restored, s)


def test_async_save(tmp_path):
    t = ckpt_lib.save_async(str(tmp_path), 3, _state(1))
    t.join()
    assert ckpt_lib.latest_step(str(tmp_path)) == 3


def test_async_snapshot_is_taken_before_return(tmp_path):
    """The state is updated in place after ``save_async`` returns (as the
    optimizer does): the checkpoint holds the values of the call."""
    s = _state(2)
    want = {k: v.clone() for k, v in s["params"].items()}
    ckpt_lib.save_async(str(tmp_path), 1, s)
    for v in s["params"].values():
        v.add_(1.0)
    ckpt_lib.wait_pending()
    restored, _ = ckpt_lib.restore(str(tmp_path), like=s)
    _equal(restored["params"], want)


def test_shape_mismatch_rejected(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, _state(2))
    bad = _state(2)
    bad["params"]["w"] = torch.zeros(9, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_lib.restore(str(tmp_path), like=bad)


def test_async_save_error_is_reraised(tmp_path):
    ckpt_lib.wait_pending()
    t = ckpt_lib.save_async(str(tmp_path / "f" / "\0bad"), 1, _state())
    t.join()
    with pytest.raises(Exception):
        ckpt_lib.wait_pending()
    ckpt_lib.wait_pending()            # errors are consumed, not sticky


def test_async_pending_stays_bounded(tmp_path):
    for i in range(8):
        ckpt_lib.save_async(str(tmp_path), i, _state(), keep=2)
    ckpt_lib.wait_pending()
    ckpt_lib.save_async(str(tmp_path), 99, _state(), keep=2)
    assert len(ckpt_lib._pending) <= 1   # finished threads were pruned
    ckpt_lib.wait_pending()


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_corruption_detected(tmp_path, mode):
    s = _state(3)
    ckpt_lib.save(str(tmp_path), 5, s)
    corrupt_checkpoint(str(tmp_path), mode=mode, array="params")
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        ckpt_lib.restore(str(tmp_path), like=s)
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        ckpt_lib.restore(str(tmp_path))    # like=None verifies too


def test_restore_latest_verified_falls_back_and_quarantines(tmp_path):
    s = _state(5)
    ckpt_lib.save(str(tmp_path), 1, s)
    ckpt_lib.save(str(tmp_path), 2, s)
    corrupt_checkpoint(str(tmp_path), step=2, mode="bitflip")
    state, step, quarantined = ckpt_lib.restore_latest_verified(
        str(tmp_path), like=s)
    assert step == 1 and quarantined == [2]
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002.corrupt"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 1
    corrupt_checkpoint(str(tmp_path), step=1, mode="truncate")
    assert ckpt_lib.restore_latest_verified(str(tmp_path), like=s) is None


def test_manifestless_dir_skipped(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, _state(6))
    os.makedirs(tmp_path / "step_00000009")
    assert ckpt_lib.latest_step(str(tmp_path)) == 1
    assert ckpt_lib.restore(str(tmp_path), like=_state(6))[1] == 1


def test_unreadable_manifest_is_corrupt_not_crash(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, _state(7))
    with open(tmp_path / "step_00000001" / "manifest.json", "w") as f:
        f.write("{not json")
    with pytest.raises(ckpt_lib.CorruptCheckpointError):
        ckpt_lib.restore(str(tmp_path), step=1, like=_state(7))


def test_dtype_mismatch_is_explicit_error(tmp_path):
    ckpt_lib.save(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt_lib.restore(str(tmp_path),
                         like={"w": torch.ones(4, dtype=torch.bfloat16)})


def _elastic_rank(rank, world_mesh, *, d):
    """tests/test_checkpoint.py's ELASTIC_SCRIPT on 4 gloo ranks."""
    mesh_a = tmesh._make_mesh((4,), ("model",), device="cpu",
                              all_ranks_group=True)
    pol_a = Policy.for_mesh(mesh_a)
    full = torch.arange(64.0).reshape(8, 8)
    block = full[2 * rank:2 * rank + 2].clone()
    ckpt_lib.save(d, 1, {"w": block}, policy=pol_a,
                  parts={"w": P("model", None)})
    man = json.load(open(os.path.join(d, "step_00000001",
                                      "manifest.json")))
    mesh_b = tmesh._make_mesh((2, 2), ("data", "model"), device="cpu",
                              all_ranks_group=True)
    pol_b = Policy.for_mesh(mesh_b)
    parts_b = {"w": P("data", "model")}
    like = {"w": torch.zeros(4, 4)}
    out = {"mesh": man["mesh"], "spec": man["leaves"][0]["spec"]}
    try:
        ckpt_lib.restore(d, like=like, policy=pol_b, parts=parts_b)
        out["plain"] = "no error"
    except ckpt_lib.MeshMismatchError as e:
        out["plain"] = str(e)
    plans = ckpt_lib.plan_reshard(d, pol_b, parts_b, like=like)
    out["src"], out["dst"] = plans[0].src, plans[0].dst
    out["resharded"] = ckpt_lib.restore_resharded(
        d, pol_b, parts_b, like=like)[0]["w"]
    out["same_mesh"] = ckpt_lib.restore(
        d, like={"w": torch.zeros(2, 8)}, policy=pol_a,
        parts={"w": P("model", None)})[0]["w"]
    out["replicated"] = ckpt_lib.restore_resharded(
        d, None, like={"w": torch.zeros(8, 8)})[0]["w"]
    torch.distributed.barrier()
    return out


def test_elastic_restore_across_meshes(tmp_path):
    """Save sharded on mesh (4,): the manifest records the factorization
    and the spec; plain restore on (2, 2) raises MeshMismatchError naming
    restore_resharded; restore_resharded lands each rank's (data, model)
    block; the same mesh restores plainly; a replicated landing gives the
    whole array."""
    d = str(tmp_path)
    ranks = tmesh.spawn(functools.partial(_elastic_rank, d=d), 4,
                        device="cpu", timeout_s=120)
    full = np.arange(64.0).reshape(8, 8)
    from repro_torch.core.linop import Layout
    for r, out in enumerate(ranks):
        assert out["mesh"] == {"model": 4}
        assert out["spec"] == ["model", None]
        assert "restore_resharded" in out["plain"]
        assert out["src"] == Layout("model", 0)
        assert out["dst"] is None          # two named axes: no single layout
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(out["resharded"],
                                      full[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(out["same_mesh"],
                                      full[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["replicated"], full)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

B, S = 4, 24


@pytest.fixture(scope="module")
def two_steps():
    """Reduced glm4-9b (fp32) after two AdamW steps in the reference:
    (cfg, JAX cfg, JAX opt, JAX step, JAX state, batches)."""
    jcfg = jconfigs.reduced(jconfigs.get_config("glm4-9b"))
    cfg = configs.reduced(configs.get_config("glm4-9b"))
    jopt = jmake_optimizer(jcfg.optimizer, total_steps=10, base_lr=1e-3)
    jstep = jax.jit(jtrain.build_train_step(jcfg, None, jopt))
    ds = jdata.SyntheticLM(jdata.DataConfig(vocab_size=jcfg.vocab_size,
                                            seq_len=S, global_batch=B,
                                            seed=0))
    state = jtrain.init_train_state(
        jcfg, jinit_params(jcfg, jax.random.PRNGKey(0)), jopt)
    for i in range(2):
        state, _ = jstep(state, {k: jnp.asarray(v)
                                 for k, v in ds.batch(i).items()})
    return cfg, jcfg, jstep, state, ds


def _port_state(cfg, jstate):
    """The reference's train state carried over leaf by leaf."""
    host = jax.device_get(jstate)
    return {"params": params_from_jax(host["params"]),
            "opt": {"m": params_from_jax(host["opt"]["m"]),
                    "v": params_from_jax(host["opt"]["v"]),
                    "count": int(host["opt"]["count"])},
            "step": int(host["step"]),
            "skipped_steps": int(host["skipped_steps"])}


def _fresh_port_state(cfg):
    opt = make_optimizer(cfg.optimizer, total_steps=10, base_lr=1e-3)
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return train.init_train_state(cfg, params, opt), opt


def test_same_files_byte_for_byte(two_steps, tmp_path):
    """Each package saves the same state: every file, the manifest
    included, is the same bytes, and the port's keys are the reference's
    in its leaf order (so ``arr_<i>`` names the same leaf)."""
    cfg, _, _, jstate, _ = two_steps
    jckpt.save(str(tmp_path / "jax"), 2, jstate)
    ckpt_lib.save(str(tmp_path / "port"), 2, _port_state(cfg, jstate))
    a, b = tmp_path / "jax" / "step_00000002", tmp_path / "port" / \
        "step_00000002"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors
    keys = [e["key"] for e in json.load(open(a / "manifest.json"))["leaves"]]
    assert keys == ckpt_lib._tree_paths(_port_state(cfg, jstate))[0]
    assert keys[0] == "opt/count" and keys[-2:] == ["skipped_steps", "step"]


def test_jax_checkpoint_restores_in_port_and_steps_on(two_steps, tmp_path):
    cfg, _, jstep, jstate, ds = two_steps
    jckpt.save(str(tmp_path), 2, jstate)
    like, opt = _fresh_port_state(cfg)
    state, step, quarantined = ckpt_lib.restore_latest_verified(
        str(tmp_path), like=like)
    assert step == 2 and quarantined == []
    _equal(state, _port_state(cfg, jstate))
    assert state["step"] == 2 and state["opt"]["count"] == 2
    port_step = train.build_train_step(cfg, opt)
    state, met = port_step(state, ds.batch(2))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                  for k, v in ds.batch(2).items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=TOL, atol=TOL)
    want = flatten(jax.device_get(jstate["params"]))
    for k, v in state["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert state["step"] == int(jstate["step"]) == 3


def test_port_checkpoint_restores_in_jax(two_steps, tmp_path):
    cfg, _, _, jstate, _ = two_steps
    ckpt_lib.save(str(tmp_path), 2, _port_state(cfg, jstate))
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
    restored, step = jckpt.restore(str(tmp_path), like=like)
    assert step == 2
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jstate),
                            jax.tree_util.tree_leaves(restored)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_reference_bf16_leaf_restores_in_port(tmp_path):
    """The reference writes an ml_dtypes bf16 leaf under npy descr '<V2';
    its own restore(like=...) then refuses it (a known caveat of the
    reference), and the port restores it as bf16, bitwise."""
    w = (np.arange(24, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    jckpt.save(str(tmp_path), 1, {"w": jnp.asarray(w.reshape(4, 6))})
    man = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert man["leaves"][0]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="dtype mismatch"):
        jckpt.restore(str(tmp_path), like={"w": jax.ShapeDtypeStruct(
            (4, 6), jnp.bfloat16)})
    got, _ = ckpt_lib.restore(
        str(tmp_path), like={"w": torch.zeros(4, 6, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  w.view(np.int16).reshape(4, 6))
    # and the port writes the same file back
    ckpt_lib.save(str(tmp_path / "port"), 1, got)
    assert filecmp.cmp(tmp_path / "step_00000001" / "arr_0.npy",
                       tmp_path / "port" / "step_00000001" / "arr_0.npy",
                       shallow=False)
