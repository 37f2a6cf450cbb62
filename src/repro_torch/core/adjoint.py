"""Adjoint-test harness (paper §3 "Implementation", Eq. 13); mirrors
``repro/core/adjoint.py``.

Data-movement operators are linear, so F is its own Jacobian and a manually
implemented adjoint F* is checked without numerical gradients:

    |<Fx, y> - <x, F*y>|
    --------------------------------------  <  eps
    max(||Fx|| ||y||,  ||x|| ||F*y||)

F* comes from torch itself: ``torch.autograd.grad`` through the forward,
with ``y`` as ``grad_outputs``.  So the test verifies that the backward
written by hand in each ``torch.autograd.Function`` *is* the adjoint of its
forward under the Euclidean inner product.

Each process holds one rank's local part of a global vector.  The inner
product runs over the global space: the local partial sums are all-reduced
over the process groups that the space is stacked over (``groups``), and a
space replicated over an axis is counted once, because that axis is not
among its groups (README, "Cotangent convention").  With no groups the
vectors are local, as for the memory operators.

Tensors may come in nested lists, tuples or dicts (the port's stand-in for
a pytree, ``repro_torch.tree``): the inner product sums over all leaves.
Products are summed in float64, for fp32 and fp64 inputs alike.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..tree import tree_leaves, tree_map
from . import primitives as prim

__all__ = ["inner", "norm", "adjoint_test", "AdjointReport"]


def _groups(groups) -> tuple:
    """None, one process group or a sequence of them, as a tuple."""
    if groups is None:
        return ()
    if isinstance(groups, (list, tuple)):
        return tuple(groups)
    return (groups,)


def inner(a, b, groups=None) -> torch.Tensor:
    """Euclidean inner product (paper Eq. 2) of the global vectors whose
    local parts are ``a`` and ``b``: a float64 scalar, equal on every rank."""
    leaves_a, leaves_b = tree_leaves(a), tree_leaves(b)
    if len(leaves_a) != len(leaves_b):
        raise ValueError(f"{len(leaves_a)} leaves against {len(leaves_b)}")
    total = torch.zeros((), dtype=torch.float64, device=leaves_a[0].device)
    for la, lb in zip(leaves_a, leaves_b):
        total = total + torch.sum(la.double() * lb.double())
    for group in _groups(groups):
        total = prim._all_reduce(total, prim.group_axis(group))
    return total


def norm(a, groups=None) -> torch.Tensor:
    """Induced norm sqrt(<a, a>) (paper Eq. 13 denominator)."""
    return torch.sqrt(inner(a, a, groups))


class AdjointReport:
    """Outcome of one Eq. 13 coherence test: name, rel_err, pass/fail.

    ``detail`` (optional) localizes a FAILING composite: which op position
    in the chain first breaks Eq. 13 and its space signature, filled in by
    ``linop.check_adjoint``; empty on passing reports.
    """

    def __init__(self, name: str, rel_err: float, eps: float,
                 detail: str = ""):
        self.name = name
        self.rel_err = float(rel_err)
        self.eps = float(eps)
        self.passed = self.rel_err < eps
        self.detail = detail

    def __repr__(self):
        status = "PASS" if self.passed else "FAIL"
        extra = f"; {self.detail}" if self.detail else ""
        return (f"AdjointReport({self.name}: rel_err={self.rel_err:.3e} "
                f"< {self.eps:.1e} [{status}]{extra})")


@torch.no_grad()
def rel_err(fx, y, x, fstar_y, x_groups=None, y_groups=None) -> float:
    """The Eq. 13 ratio for one pair: <Fx, y> over the output's space,
    <x, F*y> over the input's."""
    lhs = inner(fx, y, y_groups)
    rhs = inner(x, fstar_y, x_groups)
    denom = torch.maximum(norm(fx, y_groups) * norm(y, y_groups),
                          norm(x, x_groups) * norm(fstar_y, x_groups))
    denom = torch.clamp(denom, min=1e-30)
    return float(torch.abs(lhs - rhs) / denom)


def _draw(like, generator):
    """A standard normal tensor of ``like``'s shape, dtype and device."""
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32).to(like.dtype)


def adjoint_test(
    f: Callable,
    x,
    y=None,
    *,
    generator: torch.Generator | None = None,
    eps: float = 1e-4,
    name: str = "op",
    x_groups=None,
    y_groups=None,
) -> AdjointReport:
    """Run the paper's Eq. 13 coherence test on linear operator ``f``.

    Args:
      f: a linear function of one argument (a tensor or a tree of them).
        It receives a copy of ``x``, so an operator that acts in place
        (``memory.clear``, ``memory.copy_inplace``) may mutate it.
      x: this rank's local input (values used directly; supply random ones).
      y: the cotangent, matching ``f(x)``; drawn from ``generator`` (seed 0
        on ``x``'s device when None) when not given.  The parity tests pass
        the JAX side's numpy draws here.
      x_groups, y_groups: the process groups that the input's and the
        output's spaces are stacked over (see the module docstring).
    """
    x_leaf = tree_map(lambda t: t.detach().requires_grad_(True), x)
    fx = f(tree_map(torch.clone, x_leaf))
    fx_leaves = tree_leaves(fx)
    if y is None:
        if generator is None:
            generator = torch.Generator(
                device=fx_leaves[0].device).manual_seed(0)
        y = tree_map(lambda t: _draw(t, generator), fx)
    xs = tree_leaves(x_leaf)
    grads = torch.autograd.grad(fx_leaves, xs, tree_leaves(y),
                                allow_unused=True)
    fstar_y = [torch.zeros_like(t) if g is None else g
               for t, g in zip(xs, grads)]
    err = rel_err(fx_leaves, y, xs, fstar_y, x_groups, y_groups)
    return AdjointReport(name, err, eps)
