"""dist_jit: run a whole block body as ONE per-rank region (mirrors
``repro/core/compile.py``).

The reference lifts a block body into one ``shard_map`` whose boundary is
declared with logical ``Partitioned`` specs.  The port's region does the
same per rank, with nothing to compile: ``dist_jit(fn, policy, in_parts,
out_parts)`` returns a function of GLOBAL tensors (held the same on every
rank) that

1. restricts each input leaf to this rank's block of every dim its
   resolved spec splits (``shard_slice_replicated``; a dim split over a
   tuple of axes is split major axis first, as ``PartitionSpec`` lays it),
2. runs ``fn`` on the blocks under ``use_mesh(policy.mesh)`` with a
   ``DistContext`` pushed, so the context-aware layers (``core/layers.py``)
   resolve logical axis names and ``explicit_tp`` through it, and
3. assembles each output leaf back into the global tensor
   (``all_gather_replicated``).

Gradients cross the boundary by ``shard_map``'s own rule, the transpose the
reference's regions get (``compat.shard_map`` sets ``check_vma=False``):
the cotangent of an output is divided by the size of every mesh axis its
out-spec leaves replicated, and the cotangent of an input is summed over
every mesh axis its in-spec leaves replicated (``primitives.broadcast`` at
entry, whose adjoint is that sum).  Inside the body a replicated value's
cotangent is therefore a per-rank CONTRIBUTION, as in JAX, not the full
value of the port's explicit-copy convention (``primitives.py``): a
replicated result that the body sums over an axis uses ``all_reduce``
(adjoint: the sum), which is what the reference's ``sum_reduce`` is.  The
rule needs no knowledge of the body: an axis the body never touches makes
every rank along it compute the same thing, so each holds the cotangent
divided by k and the entry sum restores it once (README, "Cotangent
convention").  The same holds for a restriction inside the body
(``layers.shard_slice``, whose adjoint zero-pads).

``_check_boundary`` rejects an ill-typed boundary before anything runs,
with the reference's ``SpaceTypeError``s.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import torch
from torch.autograd import Function

from ..sharding.spec import Partitioned
from . import primitives as prim
from .linop import PartitionSpec as P
from .linop import SpaceTypeError

__all__ = ["DistContext", "current_ctx", "dist_jit", "local_blocks", "region",
           "resolve_parts"]


@dataclass(frozen=True)
class DistContext:
    """Active while a dist_jit body runs: layers read the policy (axis
    bindings, explicit_tp, ...) from here instead of taking a mesh arg."""

    policy: Any


_STACK: list[DistContext] = []


def current_ctx() -> DistContext | None:
    """The innermost active DistContext, or None outside dist_jit bodies."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def region(policy):
    """The context a region body runs in: ``use_mesh(policy.mesh)`` with
    ``policy`` as the current :class:`DistContext`.  ``dist_jit`` enters
    it around its body; a caller that already holds this rank's blocks
    (the hybrid train step) enters it directly."""
    with prim.use_mesh(policy.mesh):
        _STACK.append(DistContext(policy))
        try:
            yield
        finally:
            _STACK.pop()


def resolve_parts(parts, policy):
    """Resolve a pytree of ``Partitioned`` / ``PartitionSpec`` / ``None``
    (None = fully replicated) into a matching pytree of PartitionSpecs."""
    if parts is None:
        return P()
    if isinstance(parts, Partitioned):
        return parts.resolve(policy)
    if isinstance(parts, P):
        return parts
    if isinstance(parts, dict):
        return {k: resolve_parts(v, policy) for k, v in parts.items()}
    if isinstance(parts, (tuple, list)):
        return tuple(resolve_parts(v, policy) for v in parts)
    raise TypeError(f"cannot resolve partition declaration {parts!r}")


def _iter_specs(specs):
    """Yield every PartitionSpec leaf of a resolved boundary pytree."""
    if isinstance(specs, P):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _iter_specs(v)
    elif isinstance(specs, (tuple, list)):
        for v in specs:
            yield from _iter_specs(v)


def _entry_axes(entry) -> tuple:
    return tuple(a for a in (entry if isinstance(entry, (tuple, list))
                             else (entry,)) if a is not None)


def _check_boundary(specs, mesh, role: str):
    """Static validation of a dist_jit boundary (DESIGN §7): every named
    mesh axis must exist on the mesh, and no axis may shard two tensor
    dims of one value."""
    axes = tuple(mesh.mesh_dim_names)
    for spec in _iter_specs(specs):
        seen = set()
        for entry in spec:
            for name in _entry_axes(entry):
                if name not in axes:
                    raise SpaceTypeError(
                        f"dist_jit {role} spec {spec} names mesh axis "
                        f"{name!r} but the mesh has axes {axes}")
                if name in seen:
                    raise SpaceTypeError(
                        f"dist_jit {role} spec {spec} shards axis {name!r} "
                        f"over two tensor dims of one value")
                seen.add(name)


def _map_prefix(fn, specs, tree):
    """Apply ``fn(spec, leaf)`` to every tensor leaf of ``tree``, taking
    each leaf's spec from ``specs``, a prefix of ``tree`` (a spec leaf
    covers the whole subtree under it, as ``shard_map``'s specs do)."""
    if isinstance(specs, P):
        return _map_leaves(lambda t: fn(specs, t), tree)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"dist_jit: value keys "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)}"
                             f" do not match spec keys {sorted(specs)}")
        return {k: _map_prefix(fn, specs[k], tree[k]) for k in specs}
    if not isinstance(tree, (tuple, list)) or len(tree) != len(specs):
        raise ValueError(f"dist_jit: {len(specs)} specs for a value of "
                         f"type {type(tree).__name__}")
    return type(tree)(_map_prefix(fn, s, t) for s, t in zip(specs, tree))


def _map_leaves(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return tree


class _ScaleGrad(Function):
    """Identity forward; the cotangent times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _split(spec, policy) -> list:
    """(dim, axis) of every split over an axis of size > 1 (a split over
    one rank is the identity), major axis first within a dim."""
    return [(d, a) for d, entry in enumerate(spec)
            for a in _entry_axes(entry) if policy.axis_size(a) > 1]


def _unmentioned(spec, policy) -> list:
    named = {a for entry in spec for a in _entry_axes(entry)}
    return [a for a in policy.axis_names
            if a not in named and policy.axis_size(a) > 1]


def _enter(policy):
    def enter(spec, t):
        if t.is_floating_point():
            for axis in _unmentioned(spec, policy):
                t = prim.broadcast(t, axis)       # adjoint: sum over axis
        for d, axis in _split(spec, policy):
            k = policy.axis_size(axis)
            if t.shape[d] % k:
                raise ValueError(
                    f"dist_jit: dim {d} of an input of shape "
                    f"{tuple(t.shape)} does not divide by axis {axis!r} "
                    f"size {k} (spec {spec})")
            t = prim.shard_slice_replicated(t, axis, d)
        return t
    return enter


def _leave(policy):
    def leave(spec, t):
        k = 1
        for axis in _unmentioned(spec, policy):
            k *= policy.axis_size(axis)
        if k > 1 and t.is_floating_point():
            t = _ScaleGrad.apply(t, 1.0 / k)
        for d, axis in reversed(_split(spec, policy)):
            t = prim.all_gather_replicated(t, axis, d)
        return t
    return leave


def dist_jit(fn, policy, in_parts, out_parts):
    """Run ``fn`` as one per-rank region over ``policy.mesh``.

    Args:
      fn: the block body; positional args arrive as this rank's blocks.
          Layer calls inside use the context-aware API (``layers.affine``
          etc.).
      policy: ``sharding.Policy``: the mesh, logical-axis resolution and
          dispatch flags (``explicit_tp`` selects the ring matmuls).
      in_parts / out_parts: pytrees of ``Partitioned`` (or PartitionSpec /
          None) declaring the boundary layout of fn's args / results; a
          leaf covers the subtree under it.

    Returns a function of the GLOBAL arguments, held the same on every
    rank, that returns the global results on every rank (module
    docstring).  Every rank of the mesh must call it, in the same order.
    """
    mesh = policy.mesh
    in_specs = resolve_parts(in_parts, policy)
    out_specs = resolve_parts(out_parts, policy)
    _check_boundary(in_specs, mesh, "in_parts")
    _check_boundary(out_specs, mesh, "out_parts")

    def run(*args):
        with prim.use_mesh(mesh):
            local = _map_prefix(_enter(policy), in_specs, args)
            with region(policy):
                out = fn(*local)
            return _map_prefix(_leave(policy), out_specs, out)
    return run


def local_blocks(parts, tree, policy):
    """This rank's block of every leaf of the GLOBAL ``tree`` (held the same
    on every rank) under the boundary declaration ``parts``: the restriction
    ``dist_jit`` applies at entry, outside autograd.  A leaf no spec splits
    comes back as itself, not a copy."""
    specs = resolve_parts(parts, policy)
    with torch.no_grad(), prim.use_mesh(policy.mesh):
        return _map_prefix(_enter(policy), specs, tree)
