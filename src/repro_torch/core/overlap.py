"""Compute/communication overlap: ring collective-matmuls (mirrors
``repro/core/overlap.py``; beyond the paper).

The paper composes monolithic primitives (broadcast -> GEMM -> sum-reduce).
Here the all-gather (resp. reduce-scatter) is decomposed into a ring of
one-hop shifts with a partial matmul per step: the hop of step t is posted
(``primitives.ring_hop_start``) before step t's partial GEMM and waited on
after it.  NCCL runs the hop on its own stream, so the GEMM on the compute
stream overlaps it without a side stream of the port's own.  The ring
order and the local shapes are the reference's (``src``/``dest`` below).

The reference differentiates its unrolled ring by composition, so its
backward is the matching reverse ring.  Here each ring is an
``autograd.Function`` whose backward is that reverse ring written by hand:
the paper's adjoint, schedule included.  Call these inside a region (a
``dist_jit`` body or ``use_mesh``); at an axis of size 1 they make no hop.
"""

from __future__ import annotations

import torch
from torch.autograd import Function

from . import primitives as prim

__all__ = ["ring_allgather_matmul", "ring_matmul_reducescatter"]


def _mm_wgrad(x, g):
    """``einsum("...f,...o->fo")``: a partial GEMM's weight cotangent."""
    return x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])


def _wait(reqs):
    for req in reqs:
        req.wait()


class _RingAllGatherMatmul(Function):
    @staticmethod
    def forward(ctx, x, w, axis):
        ax = prim.resolve_axis(axis)
        size, idx = ax.size, ax.index
        f_loc = x.shape[-1]
        if w.shape[0] != f_loc * size:
            raise ValueError(f"ring_allgather_matmul: w has {w.shape[0]} "
                             f"rows, expected {f_loc} x {size}")
        chunks, x_cur, acc = [], x.contiguous(), None
        for t in range(size):
            src = (idx - t) % size            # owner of the chunk we hold
            if t < size - 1:
                nxt, reqs = prim.ring_hop_start(x_cur, ax, +1)
            part = x_cur @ w[src * f_loc:(src + 1) * f_loc]
            acc = part if acc is None else acc + part
            chunks.append(x_cur)
            if t < size - 1:
                _wait(reqs)
                x_cur = nxt
        ctx.ax, ctx.size, ctx.idx, ctx.f_loc = ax, size, idx, f_loc
        ctx.save_for_backward(w, *chunks)
        return acc

    @staticmethod
    def backward(ctx, g):
        w, *chunks = ctx.saved_tensors
        size, idx, f_loc = ctx.size, ctx.idx, ctx.f_loc
        g = g.contiguous()
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        # Reverse ring: the cotangent of the chunk held at step t goes back
        # t hops to its owner, accumulating one partial GEMM a step.
        acc = None
        for t in reversed(range(size)):
            src = (idx - t) % size
            rows = slice(src * f_loc, (src + 1) * f_loc)
            if acc is not None:
                prev, reqs = prim.ring_hop_start(acc, ctx.ax, -1)
            part = g @ w[rows].T
            if gw is not None:
                gw[rows] = _mm_wgrad(chunks[t], g)
            if acc is not None:
                _wait(reqs)
                part = part + prev
            acc = part
        return acc, gw, None


class _RingMatmulReduceScatter(Function):
    @staticmethod
    def forward(ctx, x, w, axis):
        ax = prim.resolve_axis(axis)
        size, idx = ax.size, ax.index
        n_tot = w.shape[-1]
        if n_tot % size:
            raise ValueError(f"ring_matmul_reducescatter: {n_tot} output "
                             f"columns do not divide by axis size {size}")
        n_loc = n_tot // size
        x = x.contiguous()
        acc = None
        for t in range(size):
            # The block added at step t travels (size-1-t) hops: it lands on
            # worker (idx + size-1-t) mod size, so add that worker's block.
            dest = (idx + size - 1 - t) % size
            if acc is not None:
                prev, reqs = prim.ring_hop_start(acc, ax, +1)
            part = x @ w[:, dest * n_loc:(dest + 1) * n_loc]
            if acc is not None:
                _wait(reqs)
                part = part + prev
            acc = part
        ctx.ax, ctx.size, ctx.idx, ctx.n_loc = ax, size, idx, n_loc
        ctx.save_for_backward(x, w)
        return acc

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        size, idx, n_loc = ctx.size, ctx.idx, ctx.n_loc
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        # Reverse ring: step t's partial product saw the accumulator after
        # (size-1-t) forward hops, so its cotangent is g carried back as
        # many hops; one partial GEMM a step.
        g_cur, gx = g.contiguous(), None
        for t in reversed(range(size)):
            dest = (idx + size - 1 - t) % size
            cols = slice(dest * n_loc, (dest + 1) * n_loc)
            if t > 0:
                nxt, reqs = prim.ring_hop_start(g_cur, ctx.ax, -1)
            part = g_cur @ w[:, cols].T
            gx = part if gx is None else gx + part
            if gw is not None:
                gw[:, cols] = _mm_wgrad(x, g_cur)
            if t > 0:
                _wait(reqs)
                g_cur = nxt
        return gx, gw, None


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                          axis_name) -> torch.Tensor:
    """``all_gather(x, dim=-1) @ w`` as a ring, each hop overlapping a
    partial matmul.

    Local shapes: x (..., f_loc), the worker's feature shard; w (f_tot,
    n_out_loc), all rows and the worker's output-column shard.  Returns
    (..., n_out_loc), the unfused gather-then-matmul's value.
    """
    return _RingAllGatherMatmul.apply(x, w, axis_name)


def ring_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor,
                              axis_name) -> torch.Tensor:
    """``reduce_scatter(x @ w, dim=-1)`` as a ring, each hop of the
    accumulator overlapping the next partial matmul.

    Local shapes: x (..., f_loc), the feature shard; w (f_loc, n_out_tot),
    the worker's row shard and all output columns.  Returns (...,
    n_out_tot / size): worker j holds sum_i x_i @ w_i[:, block_j].
    """
    return _RingMatmulReduceScatter.apply(x, w, axis_name)
