"""Resilience: the non-finite gradient guard (mirrors ``repro/resilience``;
fault injection and verified recovery are not ported yet, ROADMAP Queue 1)."""

from repro_torch.resilience.guard import (apply_guard, combine_flags,
                                          nonfinite_count, nonfinite_flag,
                                          tree_where)

__all__ = ["apply_guard", "combine_flags", "nonfinite_count",
           "nonfinite_flag", "tree_where"]
