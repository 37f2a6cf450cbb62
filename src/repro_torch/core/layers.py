"""Model-parallel layers composed from the operator algebra (paper §4;
mirrors ``repro/core/layers.py``).

Each layer follows the paper's algorithm, with the MPI partition replaced
by named mesh axes:

  affine  (dense):  x̂ = B x  ->  local GEMM  ->  y = R ŷ          (§4 Dense)
  conv    (sparse): x = H x  ->  ŵ,x̂ = B w,x ->  local conv -> R   (§4 Sparse)
  pool    (sparse): x = H x  ->  local pool                        (§4 Sparse)
  embedding:        local masked lookup -> R (vocab-partitioned)

TWO API LEVELS:

1. Context-aware layer functions (``affine``, ``conv_same``, ``pool``,
   ``conv1d_causal``, ``embedding``, ``affine_gather``, ``affine_scatter``)
   run on this rank's blocks inside a ``dist_jit`` region
   (``core/compile.py``).  Axis arguments are LOGICAL names resolved
   through the active policy, and under ``policy.explicit_tp`` the
   gather/scatter affines select the ring matmuls of ``core/overlap.py``.

2. ``dist_*(mesh, ...)`` wrappers keep the seed's one-region-per-layer
   signatures as deprecation shims, each routed through ``dist_jit``.

Inside a region a replicated value's cotangent is a per-rank contribution
(``core/compile.py``), as in the reference's ``shard_map`` bodies: the
paper's B on a value that arrives replicated is the identity here, and its
B* is the region's boundary sum; the paper's R, whose result stays
replicated, is ``linop.AllReduce`` (psum both ways, as the reference's
``sum_reduce``).  Data movement is expressed with ``core.linop`` operators.

Weight partitions follow the paper: affine weights live on a ``P_fo x
P_fi`` partition; the bias lives on one ``P_fo x 1`` subpartition ("to
avoid multiple counting of the bias"), realised by applying the bias only
where this rank's fi index is 0.  Local convolutions and pools are
``F.conv{1,2,3}d`` and ``F.max_pool`` / ``F.avg_pool``: the reference's
``lax.conv_general_dilated`` and ``reduce_window`` are XLA, not Pallas.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import torch
import torch.nn.functional as F

from ..sharding import Partitioned, Policy
from . import linop
from . import overlap
from . import primitives as prim
from .compile import current_ctx, dist_jit
from .partition import balanced_split, shard_offsets

__all__ = [
    # context-aware API (call inside dist_jit)
    "affine",
    "affine_gather",
    "affine_scatter",
    "conv_same",
    "conv1d_causal",
    "pool",
    "embedding",
    "shard_slice",
    # one-region-per-layer shims (deprecated)
    "dist_affine",
    "dist_conv1d_causal",
    "dist_conv_same",
    "dist_pool",
    "dist_embedding",
]


def _warn_deprecated(name: str, replacement: str) -> None:
    """Deprecation signal for the one-region-per-layer shims: numerically
    identical to the fused path, but no cross-layer overlap (README,
    'Migrating off the dist_* shims')."""
    warnings.warn(
        f"{name} is a deprecated one-shard_map-per-layer shim; declare "
        f"Partitioned specs once and call {replacement} inside a dist_jit "
        "region instead (README.md: 'Migrating off the dist_* shims')",
        DeprecationWarning, stacklevel=3)


def _ax(name):
    """Resolve a logical/physical axis name through the active DistContext
    (identity when no context or the name is already a mesh axis)."""
    ctx = current_ctx()
    if ctx is None or name is None:
        return name
    return ctx.policy.resolve_axis(name)


def _explicit_tp() -> bool:
    ctx = current_ctx()
    return ctx is not None and getattr(ctx.policy, "explicit_tp", False)


def _on_root(axis) -> float:
    """1.0 on the axis's rank 0, else 0.0: the paper's P_fo x 1 bias
    subpartition."""
    return float(prim.axis_index(axis) == 0)


def shard_slice(x, axis, dim: int):
    """Restriction to this worker's block along ``dim``: the transpose-glue
    half of a repartition (adjoint: zero-pad back, by autograd).  Where
    the axis does not divide the dim, the block is the paper's ceil-first
    balanced one (``partition.balanced_split``): the first ranks hold one
    element more."""
    axis = _ax(axis)
    if axis is None:
        return x
    k, i = prim.axis_size(axis), prim.axis_index(axis)
    offs = shard_offsets(x.shape[dim], k)
    return x.narrow(dim, offs[i], offs[i + 1] - offs[i])


# ---------------------------------------------------------------------------
# Dense layer (paper §4 "Dense layers"): y = W x + b on a P_fo x P_fi grid.
# ---------------------------------------------------------------------------

def affine(x, w, b=None, *, fo_axis: str | None, fi_axis: str | None):
    """The paper's Forward Affine Algorithm on local blocks.

    Shapes (local): x (..., n_fi_loc)  w (n_fo_loc, n_fi_loc)  b (n_fo_loc,).
    x is replicated over ``fo_axis`` and sharded over ``fi_axis``; w is
    sharded over both; the output is sharded over ``fo_axis`` and replicated
    over ``fi_axis``.

    Under ``policy.explicit_tp`` with w's fo dim unsharded, the trailing
    sum-reduce fuses with the GEMM as a ring matmul-reduce-scatter followed
    by an all-gather (psum = RS∘AG with the RS leg overlapped).
    """
    fo_axis, fi_axis = _ax(fo_axis), _ax(fi_axis)
    if (fi_axis is not None and fo_axis is None and _explicit_tp()
            and b is None and w.shape[0] % prim.axis_size(fi_axis) == 0):
        y = overlap.ring_matmul_reducescatter(x, w.T, fi_axis)
        return prim.all_gather(y, fi_axis, y.dim() - 1)
    # Step 2: x̂ <- B x.  x arrives replicated over ``fo_axis``: the forward
    # broadcast is the identity and the region's boundary sum is its B*.
    y_hat = x @ w.T
    if b is not None:
        if fi_axis is None:
            y_hat = y_hat + b
        else:
            # The bias lives on the P_fo x 1 subpartition (fi index 0 only):
            # the sum-reduce below counts it once, and its cotangent flows
            # only through the root subpartition.
            y_hat = y_hat + b * _on_root(fi_axis)
    # Step 4: y <- R ŷ, the sum over the fi axis (psum both ways).
    if fi_axis is not None:
        y_hat = linop.AllReduce(fi_axis)(y_hat)
    return y_hat


def affine_gather(x, w, b=None, *, axis: str):
    """``all_gather(x, dim=-1) @ w`` (+ b): the partitioned-broadcast affine.

    Local shapes: x (..., f_loc) feature-sharded over ``axis``; w (f_tot,
    o_loc) with output columns sharded.  Under explicit_tp the gather
    rides the ring matmul (each hop overlapping a partial GEMM); otherwise
    the unfused B-then-GEMM form.  x is this rank's block of the balanced
    split of f_tot, unequal where the axis does not divide it (the ring
    matmuls take equal blocks only).
    """
    axis = _ax(axis)
    if axis is None:
        y = x @ w
    elif _explicit_tp():
        y = overlap.ring_allgather_matmul(x, w, axis)
    else:
        y = prim.all_gather(x, axis, x.dim() - 1, balanced_split(
            w.shape[0], prim.axis_size(axis))) @ w
    return y if b is None else y + b


def affine_scatter(x, w, b=None, *, axis: str):
    """``reduce_scatter(x @ w, dim=-1)``: the partitioned-sum-reduce affine.

    Local shapes: x (..., f_loc) the contraction shard; w (f_loc, o_tot).
    Output (..., o_tot / k) scattered over ``axis``: this rank's block of
    the balanced split of o_tot, unequal where the axis does not divide
    it.  Under explicit_tp the scatter rides the ring matmul.
    """
    axis = _ax(axis)
    if axis is None:
        y = x @ w
    elif _explicit_tp():
        y = overlap.ring_matmul_reducescatter(x, w, axis)
    else:
        y = prim.reduce_scatter(x @ w, axis, x.dim() - 1, balanced_split(
            w.shape[1], prim.axis_size(axis)))
    return y if b is None else y + b


def dist_affine(mesh, x, w, b=None, *, fo_axis="model", fi_axis=None,
                batch_axis=None):
    """Distributed affine layer y = x W^T + b (paper §4 Dense).
    DEPRECATED shim: one region per layer, routed through ``dist_jit``.

    Global shapes: x (..., n_fi), w (n_fo, n_fi), b (n_fo,).
    Partition: w over (fo_axis, fi_axis); x over (batch_axis, fi_axis);
    y over (batch_axis, fo_axis).
    """
    _warn_deprecated("dist_affine", "layers.affine")
    xdims = [None] * (x.dim() - 1)
    if batch_axis is not None:
        xdims[0] = batch_axis
    in_parts = [Partitioned(*xdims, fi_axis), Partitioned(fo_axis, fi_axis)]
    args = (x, w)
    if b is not None:
        in_parts.append(Partitioned(fo_axis))
        args = args + (b,)
    out_part = Partitioned(*xdims, fo_axis)

    def body(*a):
        bb = a[2] if len(a) > 2 else None
        return affine(a[0], a[1], bb, fo_axis=fo_axis, fi_axis=fi_axis)

    return dist_jit(body, Policy.for_mesh(mesh), tuple(in_parts),
                    out_part)(*args)


# ---------------------------------------------------------------------------
# Sparse layers (paper §4 "Sparse layers"): halo exchange + local kernel op.
# ---------------------------------------------------------------------------

def conv1d_causal(x, w, *, seq_axis: str, dim: int = 1):
    """Causal depthwise conv1d under sequence sharding, on local blocks.

    x local (batch, seq_loc, channels); w (k, channels).  The halo is the
    paper's one-sided unbalanced case (App. B4): every worker needs a
    (k-1)-wide LEFT halo; the first worker's missing halo is the causal
    zero padding, which the zero-filled boundary margin provides.
    """
    seq_axis = _ax(seq_axis)
    k = w.shape[0]
    if k > 1 and seq_axis is not None:
        x = linop.HaloExchange(seq_axis, dim, k - 1, 0)(x)
    elif k > 1:
        pad = [0, 0] * x.dim()
        pad[2 * (x.dim() - 1 - dim) + 0] = k - 1   # F.pad: last dim first
        x = F.pad(x, pad)
    n = x.shape[dim] - (k - 1)
    out = x.narrow(dim, 0, n) * w[0]
    for i in range(1, k):
        out = out + x.narrow(dim, i, n) * w[i]
    return out


def dist_conv1d_causal(mesh, x, w, *, seq_axis="model", batch_axis="data"):
    """Depthwise causal conv1d with the sequence dim sharded over
    ``seq_axis``.  DEPRECATED shim (see dist_affine)."""
    _warn_deprecated("dist_conv1d_causal", "layers.conv1d_causal")

    def body(xx, ww):
        return conv1d_causal(xx, ww, seq_axis=seq_axis)

    return dist_jit(
        body, Policy.for_mesh(mesh),
        (Partitioned(batch_axis, seq_axis, None), Partitioned(None, None)),
        Partitioned(batch_axis, seq_axis, None))(x, w)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_same(x, w, b=None, *, spatial_axes: Sequence[str | None],
              ci_axis: str | None = None):
    """D-dim convolution on local blocks, stride 1, 'same' zero padding
    (paper §4 Forward Convolution Algorithm).

    Local shapes: x (n_b, ci_loc, m_0..m_{D-1}), w (co_loc, ci_loc,
    k_0..k_{D-1}), b (co_loc,).  ``spatial_axes[d]`` names the mesh axis
    sharding feature dim d (None = not sharded).  Kernels must be
    odd-sized; the halo exchange's zero boundary margins realise the global
    'same' padding.
    """
    D = len(spatial_axes)
    ks = w.shape[2:]
    if any(k % 2 == 0 for k in ks):
        raise ValueError("same-conv requires odd kernels")
    ci_axis = _ax(ci_axis)

    # Step 2: halo exchange per sharded spatial dim (nested, Eq. 11).
    pads = []
    for d, ax in enumerate(spatial_axes):
        ax = _ax(ax)
        h = (ks[d] - 1) // 2
        if ax is not None and h > 0:
            x = linop.HaloExchange(ax, 2 + d, h, h)(x)
            pads.append(0)   # boundary workers got zero margins
        else:
            pads.append(h)   # unsharded dim: ordinary local padding
    # Steps 3-5: w arrives replicated over batch/spatial axes and x over co:
    # the forward broadcasts are identities, the boundary sums their B*.
    # Step 6: local conv (valid on the halo-augmented tensor).
    y = _CONV[D](x, w, padding=tuple(pads))
    # The bias lives on one P_co x 1 subpartition: applied before the
    # reduction, on the ci root only, so the sum counts it once.
    if b is not None:
        bias = b.reshape((1, -1) + (1,) * D)
        y = y + (bias if ci_axis is None else bias * _on_root(ci_axis))
    # Step 7: y <- R over the ci axis.
    if ci_axis is not None:
        y = linop.AllReduce(ci_axis)(y)
    return y


def dist_conv_same(mesh, x, w, b=None, *, spatial_axes: Sequence[str | None],
                   batch_axis=None, co_axis=None, ci_axis=None):
    """Distributed 'same' convolution.  DEPRECATED shim.

    Global shapes: x (n_b, n_ci, m_0..m_{D-1}), w (n_co, n_ci,
    k_0..k_{D-1}), b (n_co,).
    """
    _warn_deprecated("dist_conv_same", "layers.conv_same")
    D = len(spatial_axes)
    in_parts = [Partitioned(batch_axis, ci_axis, *spatial_axes),
                Partitioned(co_axis, ci_axis, *([None] * D))]
    args = [x, w]
    if b is not None:
        in_parts.append(Partitioned(co_axis))
        args.append(b)
    out_part = Partitioned(batch_axis, co_axis, *spatial_axes)

    def body(*a):
        bb = a[2] if len(a) > 2 else None
        return conv_same(a[0], a[1], bb, spatial_axes=spatial_axes,
                         ci_axis=ci_axis)

    return dist_jit(body, Policy.for_mesh(mesh), tuple(in_parts),
                    out_part)(*args)


_POOL = {("max", 1): F.max_pool1d, ("max", 2): F.max_pool2d,
         ("max", 3): F.max_pool3d, ("avg", 1): F.avg_pool1d,
         ("avg", 2): F.avg_pool2d, ("avg", 3): F.avg_pool3d}


def pool(x, *, k: int, stride: int, op: str = "max",
         spatial_axes: Sequence[str | None]):
    """Pooling on local blocks (paper §4 Forward Pooling Algorithm).

    Supports the SPMD-uniform case: every sharded spatial extent divides
    evenly and local extents are stride-aligned, so halos are empty (App.
    B4 workers 0/1) or uniform.  The general unbalanced geometry is
    computed by ``partition.compute_halos``.
    """
    D = len(spatial_axes)
    for d, ax in enumerate(spatial_axes):
        ax = _ax(ax)
        if ax is None:
            continue
        if x.shape[2 + d] % stride != 0:
            raise ValueError("pool requires stride-aligned local extents")
        if k > stride:
            x = linop.HaloExchange(ax, 2 + d, 0, k - stride)(x)
    return _POOL[(op, D)](x, k, stride)


def dist_pool(mesh, x, *, k: int, stride: int, op: str = "max",
              spatial_axes: Sequence[str | None], batch_axis=None,
              channel_axis=None):
    """Distributed pooling.  DEPRECATED shim."""
    _warn_deprecated("dist_pool", "layers.pool")
    part = Partitioned(batch_axis, channel_axis, *spatial_axes)

    def body(xx):
        return pool(xx, k=k, stride=stride, op=op, spatial_axes=spatial_axes)

    return dist_jit(body, Policy.for_mesh(mesh), part, part)(x)


# ---------------------------------------------------------------------------
# Embedding: vocab-partitioned table; local masked lookup then sum-reduce
# (each token's row lives on exactly one worker, so the sum is exact).
# ---------------------------------------------------------------------------

def embedding(ids, table, *, vocab_axis: str):
    """Vocab-sharded embedding lookup on local blocks.

    ids local (...,) integer; table local (vocab_loc, d).  Workers look up
    only ids in their own vocab range and contribute zeros otherwise; the
    sum over ``vocab_axis`` assembles the full embedding (paper's R).
    """
    vocab_axis = _ax(vocab_axis)
    vloc = table.shape[0]
    if vocab_axis is None:
        return table[ids.clamp(0, vloc - 1)]
    local = ids - prim.axis_index(vocab_axis) * vloc
    in_range = (local >= 0) & (local < vloc)
    emb = table[local.clamp(0, vloc - 1)]
    emb = torch.where(in_range[..., None], emb, torch.zeros_like(emb))
    return linop.AllReduce(vocab_axis)(emb)


def dist_embedding(mesh, ids, table, *, vocab_axis="model", batch_axis="data"):
    """Vocab-sharded embedding.  DEPRECATED shim."""
    _warn_deprecated("dist_embedding", "layers.embedding")

    def body(ii, tt):
        return embedding(ii, tt, vocab_axis=vocab_axis)

    return dist_jit(
        body, Policy.for_mesh(mesh),
        (Partitioned(batch_axis), Partitioned(vocab_axis, None)),
        Partitioned(batch_axis, None))(ids, table)
