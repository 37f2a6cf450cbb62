"""Carry the JAX package's parameters (or caches) over to the port.

``params_from_jax`` takes the reference's pytree as numpy arrays (the
caller runs ``jax.device_get``), so this module never imports JAX, and
returns the port's flat ``{dotted key path: Tensor}`` dict leaf by leaf:
the decoders' trees, the pipeline cut's ``{"pre", "stage", "post"}`` tree
(``pre.embed``, ``stage.pos0.attn.wq``, ...), a sublayer's
(``norm_mixer``, ``attn.wq``, ...) and LeNet-5's (``{"conv1": {"w", "b"},
..., "fc3": {...}}`` -> ``conv1.w``, ..., ``fc3.b``, the keys of
``models/lenet.py``) alike, MoE leaves included (``moe.router``,
``moe.we_up`` ``(E, d, h)``, ``moe.shared.w_up``, ...).  ``to_rank_params``
cuts a global pipeline tree into the blocks one rank of a hybrid mesh
holds: its stage, its TP shard and, on a live ep axis, its contiguous
block of ``E/ep`` experts (``launch/specs.py::expert_assignment``).
"""

from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> ``{"a.b.c": leaf}``; None leaves are dropped."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, name + "."))
        elif val is not None:
            out[name] = val
    return out


def to_tensor(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a CPU tensor
    with the same dtype and values; the data is copied."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree) -> dict:
    """The JAX pytree of numpy leaves -> the port's ``{name: Tensor}`` on
    the host."""
    return {k: to_tensor(v) for k, v in flatten(tree).items()}


def to_rank_params(cfg, policy, pparams) -> dict:
    """This rank's blocks of the GLOBAL pipeline params ``pparams`` (the
    same on every rank) under ``models.pipeline_param_parts``: each stage
    leaf ``(1, n_super/S, ...)`` with its TP shard, the pre/post leaves
    whole.  Every leaf is a fresh contiguous copy, so the global tree can
    be dropped and the blocks updated in place."""
    from repro_torch.core.compile import local_blocks
    from repro_torch.models.model import pipeline_param_parts
    blocks = local_blocks(pipeline_param_parts(cfg, policy, pparams),
                          pparams, policy)
    return {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in blocks.items()}
