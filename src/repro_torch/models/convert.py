"""Carry the JAX package's parameters (or caches) over to the port.

``params_from_jax`` takes the reference's pytree as numpy arrays (the
caller runs ``jax.device_get``), so this module never imports JAX, and
returns the port's flat ``{dotted key path: Tensor}`` dict leaf by leaf.
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
