"""The non-finite gradient guard (mirrors ``repro/resilience/guard.py``,
DESIGN §9).

A NaN/Inf burst in one microbatch must skip the whole update: params and
every optimizer moment stay bitwise as they were, ``skipped_steps``
increments, and ``step`` still advances (the batch was consumed; the data
stream is addressed by step).

The decision is taken on the host: the train step reads the one-bit flag
before the update and runs the update only when it is 0, so a skipped
step's params and moments are bitwise unchanged because the update never
ran.  On a mesh (``train/step.py::build_hybrid_train_step``) the flag is
the max of every rank's flag, agreed by ONE max all-reduce over the whole
mesh at the end of the pipeline executor's drain (``core/pipeline.py``,
``primitives.mesh_all_reduce_``): the one-bit all-reduce of the
reference, and the only all-reduce the guard adds.  Every rank reads the
same bit, so every rank skips or none does.  ``combine_flags`` takes the
max over ``virtual_dp`` passes.  Where the reference selects with
``tree_where`` inside the compiled step, the port does not run the update.
The same all-reduce carries a recoverable fault that one rank raised
outside the step (``train/loop.py::run``): that rank's flag is
:data:`HOST_FAULT`, so every rank reads it at the same step and skips.

- :func:`nonfinite_count`: count of non-finite values in a tree.
- :func:`nonfinite_flag`: its one-bit form.
- :func:`combine_flags`: the max of several flags.
- :func:`host_flag`: the host's reading of a flag.
- :func:`tree_where`: leafwise ``where(ok, new, old)``, a select, never an
  arithmetic blend (``0 * nan`` would leak the NaN).
- :func:`apply_guard`: the next train state from the flag.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["HOST_FAULT", "nonfinite_count", "nonfinite_flag", "combine_flags",
           "host_flag", "tree_where", "apply_guard"]


HOST_FAULT = 2   # a rank's flag when it holds a fault from outside the step


def nonfinite_count(tree) -> torch.Tensor:
    """int32 count of non-finite values over every floating leaf of
    ``tree`` (all on one device), a 0-d tensor there.  Integer and bool
    leaves, and Python numbers, are skipped."""
    counts = [torch.sum(~torch.isfinite(leaf), dtype=torch.int32)
              for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if not counts:
        return torch.zeros((), dtype=torch.int32)
    return sum(counts[1:], counts[0])


def nonfinite_flag(tree) -> torch.Tensor:
    """The one-bit form of :func:`nonfinite_count`: int32 0 or 1."""
    return torch.clamp(nonfinite_count(tree), max=1)


def combine_flags(*flags):
    """Max-combine one-bit flags (associative and commutative, so any order
    gives the same decision)."""
    out = flags[0]
    for f in flags[1:]:
        out = torch.maximum(torch.as_tensor(out), torch.as_tensor(f))
    return out


def host_flag(flag) -> int:
    """The host's reading of a flag: its value as an int.  A ``meta``
    flag (the dry run traces shapes, so the flag holds no value) reads as
    0, a clean step: the branch that runs the update, whose memory and
    work a step pays."""
    if isinstance(flag, torch.Tensor) and flag.device.type == "meta":
        return 0
    return int(flag)


def tree_where(ok, new_tree, old_tree):
    """Leafwise ``where(ok, new, old)``, the pass-through update; ``ok`` is
    a scalar predicate (bool or 0-d tensor).  Select semantics: the rejected
    branch's NaNs never reach the kept one."""
    def pick(n, o):
        if not isinstance(n, torch.Tensor):
            return n if bool(ok) else o
        return torch.where(torch.as_tensor(ok, device=n.device), n,
                           o.to(n.dtype))
    return tree_map(pick, new_tree, old_tree)


def apply_guard(flag, state, new_params, new_opt):
    """The next train state from the host's one-bit ``flag`` (0 = clean
    step, 1 = skip).  On a skip ``params`` and ``opt`` are the previous
    state's own tensors (the caller did not run the update); ``step``
    advances and ``skipped_steps`` increments.  States made before the
    counter existed default it to 0."""
    skip = bool(host_flag(flag))
    return {
        "params": state["params"] if skip else new_params,
        "opt": state["opt"] if skip else new_opt,
        "step": state["step"] + 1,
        "skipped_steps": state.get("skipped_steps", 0) + int(skip),
    }
