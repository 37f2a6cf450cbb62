"""Distributed LeNet-5 (paper §5, Appendix C; mirrors
``repro/models/lenet.py``).

The paper's validation experiment: a LeNet-5 whose convolution/pooling
stage is spatially partitioned (halo exchanges) and whose affine stage is
partitioned over a P_fo x P_fi worker grid (broadcast -> local GEMM ->
sum-reduce), with transpose layers as glue.  Over 50 MNIST trials the
sequential and distributed networks matched (98.54% vs 98.55%).

On a 2x2 mesh the conv stage shards the image height over one axis (the
halo exchange of ``layers.conv_same``), the affine stage uses both axes as
the paper's P_fo x P_fi = 2 x 2 partition (Table 1's per-worker weight
shapes), and the stage transition is the transpose glue.  The whole
network is one ``dist_jit`` region.  The same code runs on a (1, 1) mesh,
one rank, where every halo is the global zero padding and every
collective moves nothing.

Parameters are the port's flat dict, ``{"conv1.w": ..., "fc3.b": ...}``,
the JAX pytree's key paths joined by dots (``models/convert.py`` carries
the reference's tree over leaf by leaf).  Affine weights keep the
reference's ``(d_out, d_in)`` layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core import linop
from repro_torch.core import primitives as prim
from repro_torch.core.compile import dist_jit
from repro_torch.sharding import Partitioned, Policy

from .common import dense_init

IMAGE = 28          # MNIST's height and width
CROP = (2, 12)      # conv2's VALID rows/cols inside its SAME output (14 x 14)


def lenet_init(generator: torch.Generator) -> dict:
    """LeNet-5's parameters on ``generator``'s device: conv weights
    N(0, 1/fan_in), affine weights ``dense_init`` transposed to (out, in),
    zero biases, as ``repro/models/lenet.py::lenet_init`` draws them (torch
    cannot replay threefry, so the values differ)."""
    device = generator.device

    def conv_w(o, i, kh, kw):
        return torch.randn((o, i, kh, kw), generator=generator,
                           device=device) / math.sqrt(i * kh * kw)

    def zeros(n):
        return torch.zeros((n,), device=device)

    return {
        "conv1.w": conv_w(6, 1, 5, 5), "conv1.b": zeros(6),
        "conv2.w": conv_w(16, 6, 5, 5), "conv2.b": zeros(16),
        "fc1.w": dense_init(400, 120, torch.float32, generator).T.contiguous(),
        "fc1.b": zeros(120),
        "fc2.w": dense_init(120, 84, torch.float32, generator).T.contiguous(),
        "fc2.b": zeros(84),
        "fc3.w": dense_init(84, 10, torch.float32, generator).T.contiguous(),
        "fc3.b": zeros(10),
    }


def lenet_apply_sequential(params, x):
    """x: (B, 1, 28, 28) -> logits (B, 10).  Single-device reference."""
    h = F.conv2d(x, params["conv1.w"], padding="same")
    h = F.relu(h + params["conv1.b"].reshape(1, -1, 1, 1))
    h = F.max_pool2d(h, 2, 2)                                   # 14x14
    h2 = F.conv2d(h, params["conv2.w"], padding="same")
    lo, hi = CROP
    h2 = h2[:, :, lo:hi, lo:hi]                                 # VALID 10x10
    h2 = F.relu(h2 + params["conv2.b"].reshape(1, -1, 1, 1))
    h2 = F.max_pool2d(h2, 2, 2)                                 # 5x5
    f = h2.reshape(h2.shape[0], -1)                             # (B, 400)
    f = F.relu(f @ params["fc1.w"].T + params["fc1.b"])
    f = F.relu(f @ params["fc2.w"].T + params["fc2.b"])
    return f @ params["fc3.w"].T + params["fc3.b"]


def _crop_rows(h2, axis):
    """This worker's rows of conv2's VALID window ``CROP`` along dim 2,
    where the worker holds rows [i n_loc, (i+1) n_loc) of the SAME output:
    the unbalanced-trim case of App. B (on 2 workers the offsets are
    (2, 0), as in the reference).  Every worker must keep as many rows."""
    k, i, n_loc = prim.axis_size(axis), prim.axis_index(axis), h2.shape[2]
    keep = [min(CROP[1], (j + 1) * n_loc) - max(CROP[0], j * n_loc)
            for j in range(k)]
    if len(set(keep)) != 1:
        raise ValueError(f"LeNet: {k} workers on the image height keep "
                         f"{keep} rows of the crop: not uniform")
    lo = max(CROP[0], i * n_loc) - i * n_loc
    return h2.narrow(2, lo, keep[0])


def _lenet_body(params, x, *, h_axis, w_axis):
    """The whole distributed forward on LOCAL blocks: one region."""
    # --- sparse stage: H sharded over h_axis ---
    h = L.conv_same(x, params["conv1.w"], params["conv1.b"],
                    spatial_axes=(h_axis, None))
    h = F.relu(h)
    h = L.pool(h, k=2, stride=2, op="max", spatial_axes=(h_axis, None))
    h2 = L.conv_same(h, params["conv2.w"], params["conv2.b"],
                     spatial_axes=(h_axis, None))
    h2 = F.relu(_crop_rows(h2, h_axis)[:, :, :, CROP[0]:CROP[1]])

    # --- transpose glue (paper Fig. C10): gather spatial, go feature-parallel
    h2 = linop.AllGather(h_axis, 2)(h2)
    h2 = F.max_pool2d(h2, 2, 2)                                  # 5x5
    f = h2.reshape(h2.shape[0], -1)                              # (B, 400)

    # --- dense stage: P_fo x P_fi, Table 1 local shapes ---
    # restriction to this worker's fi block = the paper's transpose glue
    # (adjoint: zero-pad, by autograd); then the affine B -> GEMM -> R.
    def fc(f, layer):
        f = L.shard_slice(f, w_axis, -1)
        return L.affine(f, params[f"{layer}.w"], params[f"{layer}.b"],
                        fo_axis=h_axis, fi_axis=w_axis)

    f = F.relu(fc(f, "fc1"))                                 # local w (60, 200)
    f = linop.AllGather(h_axis, f.dim() - 1)(f)              # fo -> fi
    f = F.relu(fc(f, "fc2"))                                 # local w (42, 60)
    f = linop.AllGather(h_axis, f.dim() - 1)(f)
    return fc(f, "fc3")                                      # local w (5, 42)


def lenet_apply_distributed(mesh, params, x, *, h_axis="fo", w_axis="fi"):
    """Distributed forward on a (h_axis, w_axis) mesh, (2, 2) as in the
    paper or (1, 1).

    Conv stage: image height sharded over ``h_axis`` (halo exchanges).
    Affine stage: P_fo x P_fi = (h_axis, w_axis).  The flatten between
    them is the paper's transpose glue.  ``params`` and ``x`` are the
    global values, the same on every rank; so are the logits returned.
    """
    p_parts = {f"conv{i}.{k}": None for i in (1, 2) for k in ("w", "b")}
    for layer in ("fc1", "fc2", "fc3"):
        p_parts[f"{layer}.w"] = Partitioned(h_axis, w_axis)
        p_parts[f"{layer}.b"] = Partitioned(h_axis)

    def body(pp, xx):
        return _lenet_body(pp, xx, h_axis=h_axis, w_axis=w_axis)

    return dist_jit(
        body, Policy.for_mesh(mesh),
        (p_parts, Partitioned(None, None, h_axis, None)),
        Partitioned(None, h_axis))(params, x)


def table1_local_shapes(mesh_shape=(2, 2)):
    """Paper Table 1: per-worker learnable parameter shapes."""
    pfo, pfi = mesh_shape
    return {
        "C5": (120 // pfo, 400 // pfi),   # (60, 200)
        "F6": (84 // pfo, 120 // pfi),    # (42, 60)
        "Output": (10 // pfo, 84 // pfi),  # (5, 42)
    }


def synthetic_mnist(generator: torch.Generator, n: int, noise: float = 0.35):
    """MNIST-shaped synthetic classification task: 10 fixed prototype
    'digits' (from their own seed, shared by every split) plus Gaussian
    noise; learnable to ~99% by LeNet quickly.  Returns (images (n, 1, 28,
    28), labels (n,)) on ``generator``'s device.  Torch cannot replay the
    reference's threefry draws, so the data differ from JAX's."""
    device = generator.device
    protos = torch.randn((10, 1, IMAGE, IMAGE), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(314159))
    labels = torch.randint(0, 10, (n,), generator=generator, device=device)
    imgs = protos[labels] + noise * torch.randn(
        (n, 1, IMAGE, IMAGE), generator=generator, device=device)
    return imgs, labels
