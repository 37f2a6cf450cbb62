"""Static analysis of the operator algebra (mirrors ``repro/analysis``;
DESIGN §7).

- ``spaces``: the static space type-checker: validates that a composite
  ``LinearOp`` is a well-typed map between the paper's global vector
  spaces (replicated F^n vs k-worker-stacked F^{kn}) before any
  communication, and is the move registry the port's adjoint fuzzer
  samples from.

The reference's ``hlo_lint`` reads compiled XLA HLO, which torch does not
produce; its rules wait for ROADMAP Queue 1 item 12.  Submodules load
lazily, so ``python -m repro_torch.analysis.spaces`` runs without a
double-import warning.
"""

__all__ = ["spaces", "typecheck"]


def __getattr__(name):
    """Resolve ``spaces`` and ``typecheck`` on first access."""
    import importlib
    if name == "spaces":
        return importlib.import_module(".spaces", __name__)
    if name == "typecheck":
        return importlib.import_module(".spaces", __name__).typecheck
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
