"""Tensor partitions and generalized (unbalanced) halo geometry.

Implements the paper's load-balance and halo-size machinery (§3 "Halo
exchange", Appendix B):

- ``balanced_split``: the canonical ceil-first balanced 1-D decomposition
  (numpy.array_split semantics) used for every partitioned tensor dimension.
- ``conv_output_size``: output length of a sliding-kernel op with size /
  stride / dilation / padding.
- ``compute_halos``: per-worker halo geometry for one dimension, driven by
  *output* load balance (paper: "computational load on a given worker is
  driven by the volume of that worker's output subtensor").  Produces the
  irregular structures of Appendix B: one-sided halos, unbalanced widths,
  and *unused* bulk entries that must be trimmed before the local kernel op
  (Figures B3-B5).
- ``TensorPartition``: a d-dimensional worker grid with per-dimension index
  ranges, the paper's partition vector P.

All functions are pure Python on static shapes: they run before any
tensor moves and feed static paddings and slices into the primitives.
A copy of ``repro/core/partition.py``, which the port may not import.
"""

from __future__ import annotations


from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "balanced_split",
    "shard_offsets",
    "conv_output_size",
    "HaloSpec",
    "compute_halos",
    "is_sensible_decomposition",
    "max_halo_widths",
    "TensorPartition",
]


def balanced_split(n: int, parts: int) -> list[int]:
    """Sizes of a ceil-first balanced split of ``n`` into ``parts``.

    Matches numpy.array_split: the first ``n % parts`` shards get one extra
    element.  This is the load-balanced decomposition the paper assumes for
    every distributed tensor dimension.
    """
    if parts <= 0:
        raise ValueError("parts must be positive")
    q, r = divmod(n, parts)
    return [q + 1] * r + [q] * (parts - r)


def shard_offsets(n: int, parts: int) -> list[int]:
    """Start offsets (length parts+1) of the balanced split."""
    sizes = balanced_split(n, parts)
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


def conv_output_size(n: int, k: int, stride: int = 1, dilation: int = 1,
                     padding: int = 0) -> int:
    """Output length of a sliding kernel (PyTorch convention)."""
    eff_k = dilation * (k - 1) + 1
    return (n + 2 * padding - eff_k) // stride + 1


@dataclass(frozen=True)
class HaloSpec:
    """Halo geometry for one worker in one dimension (paper App. B).

    ``left_halo``/``right_halo``: widths of neighbour data this worker must
    receive to compute its outputs.
    ``left_unused``/``right_unused``: bulk entries this worker owns but must
    *trim* before the local kernel op (Figures B4-B5 "extra input ... has to
    be removed").
    ``bulk``: [lo, hi) global input range owned by this worker.
    ``out``: [lo, hi) global output range computed by this worker.
    ``needed``: [lo, hi) global input range required for ``out``.
    """

    index: int
    bulk: tuple[int, int]
    out: tuple[int, int]
    needed: tuple[int, int]
    left_halo: int
    right_halo: int
    left_unused: int
    right_unused: int

    @property
    def local_in_size(self) -> int:
        """Local input extent after halo exchange and trimming."""
        return self.needed[1] - self.needed[0]


def compute_halos(
    n: int,
    parts: int,
    k: int,
    stride: int = 1,
    dilation: int = 1,
    padding: int = 0,
) -> list[HaloSpec]:
    """Per-worker halo geometry for one dimension.

    The *output* is balanced (ceil-first) over ``parts`` workers; the input
    bulk is the balanced split of ``n``.  For output index j, the kernel
    reads global inputs [j*stride - padding, j*stride - padding +
    dilation*(k-1)] (clipped to [0, n)); a worker's needed range is the union
    over its outputs.  Halos and unused trims follow by comparing needed
    range with owned bulk.
    """
    m = conv_output_size(n, k, stride, dilation, padding)
    if m < parts:
        raise ValueError(f"output size {m} < parts {parts}: dimension over-partitioned")
    in_offs = shard_offsets(n, parts)
    out_offs = shard_offsets(m, parts)
    specs: list[HaloSpec] = []
    eff_reach = dilation * (k - 1)
    for i in range(parts):
        o_lo, o_hi = out_offs[i], out_offs[i + 1]
        need_lo = o_lo * stride - padding
        need_hi = (o_hi - 1) * stride - padding + eff_reach + 1  # exclusive
        # Global zero-padding is materialised locally by the layer shim, so
        # clip the needed range to the physical tensor.
        need_lo_c = max(0, need_lo)
        need_hi_c = min(n, need_hi)
        b_lo, b_hi = in_offs[i], in_offs[i + 1]
        specs.append(
            HaloSpec(
                index=i,
                bulk=(b_lo, b_hi),
                out=(o_lo, o_hi),
                needed=(need_lo_c, need_hi_c),
                left_halo=max(0, b_lo - need_lo_c),
                right_halo=max(0, need_hi_c - b_hi),
                left_unused=max(0, need_lo_c - b_lo),
                right_unused=max(0, b_hi - need_hi_c),
            )
        )
    return specs


def is_sensible_decomposition(specs: Sequence[HaloSpec]) -> bool:
    """Paper §3: "we assume that the tensors are sensibly decomposed,
    relative to kernel size, so that halos require data from directly
    adjacent neighbor workers only."  Returns False when any worker's halo
    exceeds its neighbour's bulk (the exchange would need 2-hop data)."""
    for i, s in enumerate(specs):
        if i > 0:
            prev = specs[i - 1]
            if s.left_halo > prev.bulk[1] - prev.bulk[0]:
                return False
        if i < len(specs) - 1:
            nxt = specs[i + 1]
            if s.right_halo > nxt.bulk[1] - nxt.bulk[0]:
                return False
    return True


def max_halo_widths(specs: Sequence[HaloSpec]) -> tuple[int, int]:
    """Uniform (left, right) buffer widths covering all workers.

    SPMD programs need identical local shapes on every shard, so buffers are
    sized to the worst-case halo and per-worker masks trim the difference
    (a diagonal — hence linear, hence adjoint-exact — operator).
    """
    return (
        max(s.left_halo for s in specs),
        max(s.right_halo for s in specs),
    )


@dataclass(frozen=True)
class TensorPartition:
    """A d-dimensional partition P of a global tensor shape (paper §4).

    ``pvector[i]`` workers along dimension i; worker coordinates are
    lexicographic.  Provides the global index ranges of each worker's
    subtensor under balanced decomposition.
    """

    shape: tuple[int, ...]
    pvector: tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.pvector):
            raise ValueError("shape and pvector rank mismatch")
        for n, p in zip(self.shape, self.pvector):
            if p < 1 or (n > 0 and p > max(n, 1)):
                raise ValueError(f"cannot split extent {n} into {p} parts")

    @property
    def num_workers(self) -> int:
        return int(np.prod(self.pvector))

    def coords(self, rank: int) -> tuple[int, ...]:
        return tuple(np.unravel_index(rank, self.pvector))

    def rank(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.pvector))

    def subtensor_range(self, rank: int) -> list[tuple[int, int]]:
        """Per-dimension [lo, hi) global ranges of this worker's subtensor."""
        c = self.coords(rank)
        out = []
        for dim, (n, p) in enumerate(zip(self.shape, self.pvector)):
            offs = shard_offsets(n, p)
            out.append((offs[c[dim]], offs[c[dim] + 1]))
        return out

    def local_shape(self, rank: int) -> tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.subtensor_range(rank))

    def is_uniform(self) -> bool:
        """True when every worker owns the same local shape (required for
        single-program SPMD without padding)."""
        return all(n % p == 0 for n, p in zip(self.shape, self.pvector))
