"""Static analysis of the operator algebra and of the port's traced
programs (mirrors ``repro/analysis``; DESIGN §7).

- ``spaces``: the static space type-checker: validates that a composite
  ``LinearOp`` is a well-typed map between the paper's global vector
  spaces (replicated F^n vs k-worker-stacked F^{kn}) before any
  communication, and is the move registry the port's adjoint fuzzer
  samples from.
- ``hlo_lint``: the reference's anti-pattern rules over what torch can
  observe in place of compiled HLO, the shape trace of one step
  (``roofline/hlo_profile.py``): ``lint_trace`` returns ``Finding``
  records.

Submodules load lazily, so ``python -m repro_torch.analysis.spaces`` and
``python -m repro_torch.analysis.hlo_lint`` run without a double-import
warning.
"""

__all__ = ["spaces", "typecheck", "hlo_lint", "Finding", "lint_trace"]

_FROM = {"typecheck": "spaces", "Finding": "hlo_lint",
         "lint_trace": "hlo_lint"}


def __getattr__(name):
    """Resolve the submodules and their names on first access."""
    import importlib
    if name in ("spaces", "hlo_lint"):
        return importlib.import_module(f".{name}", __name__)
    if name in _FROM:
        return getattr(importlib.import_module(f".{_FROM[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
