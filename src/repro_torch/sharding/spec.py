"""Logical partition declarations (mirrors ``repro/sharding/spec.py``).

``Partitioned("batch", "fi")`` names the LOGICAL axis of each tensor
dimension; ``Policy.resolve_axis`` maps each name to a physical mesh axis
(or None).  Layers and ``dist_jit`` callers declare partitions once in
logical terms instead of hand-building a ``PartitionSpec`` against a
concrete mesh at every call site.

Resolution rules per entry (see ``Policy.resolve_axis``):

  None / "none"      -> replicated dimension
  a mesh axis name   -> that axis, verbatim (mesh-generic code, such as
                        tests on ("fo", "fi") or ("h", "w") meshes, skips
                        the logical table)
  a logical name     -> ``Policy.phys`` (batch, data, seq, heads, ff,
                        experts, vocab, fsdp, kvdim, model, pipe, ...),
                        extended by ``Policy.bind(...)`` aliases
  a tuple of entries -> resolved element-wise (multi-axis sharding)

The resolved spec is the port's ``core.linop.PartitionSpec``.
"""

from __future__ import annotations

from ..core.linop import PartitionSpec as P

__all__ = ["Partitioned", "Replicated"]


class Partitioned:
    """A per-dimension logical partition declaration (immutable)."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        object.__setattr__(self, "axes", tuple(axes))

    def __setattr__(self, name, value):
        raise AttributeError("Partitioned is immutable")

    def __eq__(self, other):
        return isinstance(other, Partitioned) and self.axes == other.axes

    def __hash__(self):
        return hash(("Partitioned", self.axes))

    def __repr__(self):
        return f"Partitioned({', '.join(map(repr, self.axes))})"

    def resolve(self, policy) -> P:
        """PartitionSpec for ``policy``'s mesh (trailing dims replicated)."""
        return P(*(policy.resolve_axis(a) for a in self.axes))


Replicated = Partitioned()
