"""Linear-algebraic memory model (paper §2, Appendix A); mirrors
``repro/core/memory.py``.

Every primitive memory operation (allocation, clear, add, copy, move) is a
linear operator on the space F^k of "a computer's memory".  Because they are
linear, each operator is its own Jacobian, and the adjoint that
reverse-mode differentiation needs follows from the Euclidean inner product
(paper Eq. 1-2), not from the AD tool.

Each operator is a ``torch.autograd.Function`` whose backward is the
adjoint derived by hand in Appendix A, written out step by step on the
cotangent; autograd composes these adjoints and never differentiates the
slicing itself.

A "subset of memory" is a contiguous slice ``[lo, hi)`` of a 1-D tensor.
Unlike XLA, torch has memory that an operator can overwrite, so the
paper's two constructions are both real here.  ``clear``, ``add`` and the
``*_inplace`` operators act on their input's own memory (the input is
returned, marked dirty for autograd); ``allocate``, ``deallocate``,
``take_linear`` and the ``*_outofplace`` operators return fresh memory.  An
in-place operator cannot take a leaf that requires grad: pass a copy
(``x.clone()``), as torch requires of any in-place operation.
"""

from __future__ import annotations

import torch
from torch.autograd import Function

__all__ = [
    "allocate",
    "deallocate",
    "clear",
    "add",
    "copy_inplace",
    "copy_outofplace",
    "move_inplace",
    "move_outofplace",
    "take_linear",
]


# The operators' actions on a plain tensor, in place: forwards and adjoints
# are both written with these.

def _clear_(t: torch.Tensor, sub: tuple[int, int]) -> torch.Tensor:
    """K_sub: zero ``t[sub]``."""
    t[sub[0]:sub[1]] = 0
    return t


def _add_(t: torch.Tensor, a: tuple[int, int], b: tuple[int, int]):
    """S_{a->b}: ``t[b] += t[a]``, reading ``t[a]`` before any write."""
    t[b[0]:b[1]] += t[a[0]:a[1]].clone()
    return t


def _allocate(t: torch.Tensor, n_new: int) -> torch.Tensor:
    """A_b: ``[t; 0_b]`` in fresh memory."""
    return torch.cat([t, t.new_zeros((n_new,))])


def _deallocate(t: torch.Tensor, n_drop: int) -> torch.Tensor:
    """D_b: the leading ``len(t) - n_drop`` entries, in fresh memory."""
    return t[: t.shape[0] - n_drop].clone()


# ---------------------------------------------------------------------------
# Allocation  A_b : F^m -> F^n   (paper Eq. 3);  adjoint = deallocation (Eq. 4)
# ---------------------------------------------------------------------------

class _Allocate(Function):
    @staticmethod
    def forward(ctx, x, n_new):
        ctx.n_new = n_new
        return _allocate(x, n_new)

    @staticmethod
    def backward(ctx, g):
        # A* = [I_a  O_b]: drop the cotangent on the new subset.
        return _deallocate(g, ctx.n_new), None


def allocate(x: torch.Tensor, n_new: int) -> torch.Tensor:
    """A_b x = [x; 0_b]: bring ``n_new`` zero elements into scope."""
    return _Allocate.apply(x, n_new)


class _Deallocate(Function):
    @staticmethod
    def forward(ctx, x, n_drop):
        ctx.n_drop = n_drop
        return _deallocate(x, n_drop)

    @staticmethod
    def backward(ctx, g):
        return _allocate(g, ctx.n_drop), None


def deallocate(x: torch.Tensor, n_drop: int) -> torch.Tensor:
    """D_b x = [x_a]: drop the trailing subset.  D* = A (allocation)."""
    return _Deallocate.apply(x, n_drop)


# ---------------------------------------------------------------------------
# Clear  K_b : F^m -> F^m   (paper Eq. 5), self-adjoint; in place.
# ---------------------------------------------------------------------------

class _Clear(Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.sub = (lo, hi)
        ctx.mark_dirty(x)
        return _clear_(x, (lo, hi))

    @staticmethod
    def backward(ctx, g):
        # K* = K: the cleared subset receives no cotangent.
        return _clear_(g.clone(), ctx.sub), None, None


def clear(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """K_b x: zero the subset x[lo:hi], in x's own memory."""
    return _Clear.apply(x, lo, hi)


# ---------------------------------------------------------------------------
# Add  S_{a->b} : F^m -> F^m   (paper Eq. 6);  adjoint S_{b->a} (Eq. 7).
# ---------------------------------------------------------------------------

class _Add(Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.a, ctx.b = a, b
        ctx.mark_dirty(x)
        return _add_(x, a, b)

    @staticmethod
    def backward(ctx, g):
        # S*_{a->b} = S_{b->a}: the destination's cotangent adds into the
        # source's.
        return _add_(g.clone(), ctx.b, ctx.a), None, None


def add(x: torch.Tensor, a: tuple[int, int], b: tuple[int, int]):
    """S_{a->b} x: x_b += x_a (subsets given as index ranges), in place."""
    return _Add.apply(x, a, b)


# ---------------------------------------------------------------------------
# Copy (paper §2 table):
#   in-place      C_{a->b} = S_{a->b} K_b,  C* = K_b S_{b->a}
#   out-of-place  C = S_{a->b} A_b,         C* = D_b S_{b->a}
# ---------------------------------------------------------------------------

class _CopyInplace(Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.a, ctx.b = a, b
        ctx.mark_dirty(x)
        return _add_(_clear_(x, b), a, b)

    @staticmethod
    def backward(ctx, g):
        return _clear_(_add_(g.clone(), ctx.b, ctx.a), ctx.b), None, None


def copy_inplace(x: torch.Tensor, a: tuple[int, int], b: tuple[int, int]):
    """C_{a->b} = S_{a->b} K_b: overwrite x_b with x_a, in x's memory."""
    return _CopyInplace.apply(x, a, b)


class _CopyOutofplace(Function):
    @staticmethod
    def forward(ctx, x, a):
        m, n = x.shape[0], a[1] - a[0]
        ctx.a, ctx.b, ctx.n = a, (m, m + n), n
        return _add_(_allocate(x, n), a, ctx.b)

    @staticmethod
    def backward(ctx, g):
        return _deallocate(_add_(g.clone(), ctx.b, ctx.a), ctx.n), None


def copy_outofplace(x: torch.Tensor, a: tuple[int, int]) -> torch.Tensor:
    """C_{a->b} = S_{a->b} A_b: [x; x_a] in fresh memory."""
    return _CopyOutofplace.apply(x, a)


# ---------------------------------------------------------------------------
# Move (paper §2 table):
#   in-place      M = K_a S_{a->b} K_b,  M* = M_{b->a}
#   out-of-place  M = D_a S_{a->b} A_b
# ---------------------------------------------------------------------------

class _MoveInplace(Function):
    @staticmethod
    def forward(ctx, x, a, b):
        ctx.a, ctx.b = a, b
        ctx.mark_dirty(x)
        return _clear_(_add_(_clear_(x, b), a, b), a)

    @staticmethod
    def backward(ctx, g):
        # M* = K_b S_{b->a} K_a = M_{b->a}.
        g = _clear_(_add_(_clear_(g.clone(), ctx.a), ctx.b, ctx.a), ctx.b)
        return g, None, None


def move_inplace(x: torch.Tensor, a: tuple[int, int], b: tuple[int, int]):
    """M_{a->b} = K_a S_{a->b} K_b: x_a moves to x_b, in x's memory."""
    return _MoveInplace.apply(x, a, b)


class _MoveOutofplace(Function):
    @staticmethod
    def forward(ctx, x, a):
        m, n = x.shape[0], a[1] - a[0]
        ctx.a, ctx.b, ctx.n = a, (m, m + n), n
        # D_a: keep every entry but the source subset (a {0,1} selection).
        ctx.keep = torch.cat([torch.arange(0, a[0], device=x.device),
                              torch.arange(a[1], m + n, device=x.device)])
        return _add_(_allocate(x, n), a, ctx.b)[ctx.keep]

    @staticmethod
    def backward(ctx, g):
        # M* = A_b* S_{a->b}* D_a* = D_b S_{b->a} (D_a's transpose).
        full = g.new_zeros((ctx.keep.shape[0] + ctx.n,))
        full.index_add_(0, ctx.keep, g)
        return _deallocate(_add_(full, ctx.b, ctx.a), ctx.n), None


def move_outofplace(x: torch.Tensor, a: tuple[int, int]) -> torch.Tensor:
    """M = D_a S_{a->b} A_b: append a copy of x_a, then drop x_a.

    The result is [x without x_a; x_a] in fresh memory: the moved subset
    occupies the newly allocated entries.
    """
    return _MoveOutofplace.apply(x, a)


class _TakeLinear(Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.m = x.shape[0]
        ctx.idx = torch.as_tensor(idx, dtype=torch.long, device=x.device)
        return x[ctx.idx]

    @staticmethod
    def backward(ctx, g):
        return g.new_zeros((ctx.m,)).index_add_(0, ctx.idx, g), None


def take_linear(x: torch.Tensor, idx) -> torch.Tensor:
    """Gather entries by a static index (a sequence or a LongTensor): a
    {0,1} selection matrix, whose adjoint is its transpose (scatter-add)."""
    return _TakeLinear.apply(x, idx)
