"""Resilience: the non-finite gradient guard, deterministic fault
injection and verified recovery (mirrors ``repro/resilience``, DESIGN §9).

The skip decision is one max all-reduce of a one-bit flag over the mesh
(``guard.py``); faults fire at exact steps on every rank (``inject.py``).
"""

from repro_torch.resilience.guard import (apply_guard, combine_flags,
                                          nonfinite_count, nonfinite_flag,
                                          tree_where)
from repro_torch.resilience.inject import (DeviceLossError, FaultInjector,
                                           FaultPlan, InjectedCrash,
                                           corrupt_checkpoint, nan_grad_hook,
                                           poison_batch)

__all__ = [
    "apply_guard", "combine_flags", "nonfinite_count", "nonfinite_flag",
    "tree_where", "DeviceLossError", "FaultInjector", "FaultPlan",
    "InjectedCrash", "corrupt_checkpoint", "nan_grad_hook", "poison_batch",
]
