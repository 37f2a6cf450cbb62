"""Optimizers: AdamW with a configurable moment dtype, Adafactor-style
factored second moment, global-norm clipping, warmup-cosine schedules and
gradient compression (mirrors ``repro/optim/optimizers.py``).

Trees are the port's flat ``{name: Tensor}`` dicts (``repro_torch.tree``).
The arithmetic is the reference's, step for step: the schedule and the bias
corrections in float32 on the host (``lr(count)`` with ``count`` = the
state's count + 1), each update in fp32 from the gradient's fp32 cast, then
cast to the parameter's and the moments' dtypes, and decoupled weight decay
on every leaf with ``ndim >= 2`` (the stacked ``(n_super, d)`` norm weights
included, as in the reference's stacked layout).

Unlike the reference, ``update`` writes the new parameters and moments into
the given tensors in place, leaf by leaf under ``torch.no_grad()``, and
returns them: no second copy of the model or its moments exists, so AdamW
over bf16 parameters holds 12 bytes a parameter with the gradients (bf16
params and grads, fp32 m and v).

Memory per parameter (bytes) for the optimizer state:
    adamw       fp32 m + fp32 v = 8
    adamw_bf16  bf16 m + bf16 v = 4
    adafactor   bf16 m + factored v ~= 2
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import math

import numpy as np
import torch

from repro_torch.core import primitives as prim
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map

f32 = np.float32


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> Callable:
    """``lr(step) -> float``, computed in float32 as the reference's jnp
    arithmetic is (every constant rounded to float32 first)."""
    def lr(step) -> float:
        step = f32(step)
        warm = f32(base_lr) * np.minimum(f32(1.0),
                                         (step + f32(1)) / f32(max(warmup, 1)))
        t = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                    f32(0.0), f32(1.0))
        cos = f32(final_frac) + f32((1 - final_frac) * 0.5) * (
            f32(1) + np.cos(f32(np.pi) * t))
        return float(warm if step < f32(warmup) else f32(base_lr) * cos)
    return lr


# ---------------------------------------------------------------------------
# Gradient utilities
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, each upcast to fp32; a 0-d
    fp32 tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in their own dtypes, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def compress_grads(grads, dtype=torch.bfloat16, generator=None):
    """Gradient compression for the cross-pod all-reduce: cast to ``dtype``,
    or, given a ``torch.Generator``, bf16 with stochastic rounding
    (unbiased: the estimator a data-parallel sum needs).  The random bits
    are torch's, not threefry's, so only the distribution matches the
    reference."""
    if generator is None:
        return tree_map(lambda g: g.to(dtype), grads)
    if dtype != torch.bfloat16:
        raise NotImplementedError("stochastic rounding implemented for bf16")

    def sr(g):
        # bf16 = top 16 bits of f32: add uniform noise in the dropped-bit
        # range, then truncate (E[sr(x)] = x).  uint32 arithmetic in int64.
        bits = g.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        noise = torch.randint(0, 1 << 16, g.shape, generator=generator,
                              device=g.device, dtype=torch.int64)
        rounded = (bits + noise) & 0xFFFF0000
        rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
        return rounded.to(torch.int32).view(torch.float32).to(dtype)

    return tree_map(sr, grads)


def _bias_corrections(b1: float, b2: float, count: int):
    return (float(f32(1) - f32(b1) ** f32(count)),
            float(f32(1) - f32(b2) ** f32(count)))


# ---------------------------------------------------------------------------
# AdamW (configurable moment dtype)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32

    def init(self, params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params, scale=None, **_):
        """Write the step into ``params`` and the moments of ``state`` in
        place; returns ``(params, new state)``.  ``scale``: optional scalar
        (a 0-d tensor) folded into the fp32 grad cast, so the caller clips
        by global norm without a clipped copy of the gradients."""
        count = state["count"] + 1
        b1, b2 = self.b1, self.b2
        lr = self.lr(count)
        c1, c2 = _bias_corrections(b1, b2, count)
        with span("optim.update"):
            for name, p in params.items():
                g32 = grads[name].float()
                if scale is not None:
                    g32 = g32 * scale
                m, v = state["m"][name], state["v"][name]
                # the reference's expressions, each in-place op on a fresh
                # temporary or on an fp32 moment being replaced (same
                # roundings)
                m32 = m.float().mul_(b1).add_(g32 * (1 - b1))
                v32 = v.float().mul_(b2).add_(g32 * g32 * (1 - b2))
                del g32
                step = (m32 / c1).div_(torch.sqrt(v32 / c2).add_(self.eps))
                if p.ndim >= 2:  # decoupled weight decay on matrices only
                    step += self.weight_decay * p.float()
                p.copy_(p.float().sub_(step.mul_(lr)))
                m.copy_(m32)
                v.copy_(v32)
        return params, {"m": state["m"], "v": state["v"], "count": count}


# ---------------------------------------------------------------------------
# Adafactor-style: bf16 momentum + factored second moment (row/col stats)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Adafactor:
    lr: Callable
    b1: float = 0.9
    decay: float = 0.99
    eps: float = 1e-30
    weight_decay: float = 0.0

    def init(self, params):
        def stats(p):
            if p.ndim >= 2:
                return {"vr": torch.zeros(p.shape[:-1], device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, device=p.device)}
        return {"m": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.bfloat16, device=p.device), params),
                "v": {k: stats(p) for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(self, grads, state, params, scale=None, splits=None,
               mesh=None):
        """As ``AdamW.update``: in place, returns ``(params, new state)``.

        ``splits`` (with ``mesh``): for each leaf held as this rank's block
        of a sharded parameter (the policy train program), the mesh axes
        that split each of its dims.  The factored statistics' means over
        a split dim and the update's rms are then sums all-reduced over
        those axes, divided by the global size, so each rank's block gets
        the global statistics."""
        count = state["count"] + 1
        lr = self.lr(count)
        d = self.decay
        with span("optim.update"):
            for name, p in params.items():
                split = (splits or {}).get(name) or ((),) * p.ndim

                def mean(x, dim, axes):
                    """``x.mean(dim)`` over the global dim (``dim`` None:
                    over every element), the dim split over ``axes``."""
                    if not axes:
                        return x.mean() if dim is None else x.mean(dim=dim)
                    s = x.sum() if dim is None else x.sum(dim=dim)
                    with prim.use_mesh(mesh):
                        prim.psum_([s], axes)
                    n = x.numel() if dim is None else x.shape[dim]
                    return s / (n * math.prod(prim.axis_size(a)
                                              for a in axes))

                g32 = grads[name].float()
                if scale is not None:
                    g32 = g32 * scale
                m, v = state["m"][name], state["v"][name]
                g2 = g32 * g32 + self.eps
                if p.ndim >= 2:
                    vr = v["vr"] * d + mean(g2, -1, split[-1]) * (1 - d)
                    vc = v["vc"] * d + mean(g2, -2, split[-2]) * (1 - d)
                    denom = (vr[..., None] * vc[..., None, :]
                             / torch.clamp(mean(vr, -1, split[-2])[..., None,
                                                                   None],
                                           min=self.eps))
                    prec = torch.rsqrt(torch.clamp(denom, min=self.eps))
                    new_v = {"vr": vr, "vc": vc}
                else:
                    vv = v["v"] * d + g2 * (1 - d)
                    prec = torch.rsqrt(torch.clamp(vv, min=self.eps))
                    new_v = {"v": vv}
                u = g32 * prec
                # clip update rms to 1 (adafactor stability)
                every = tuple(dict.fromkeys(a for axes in split
                                            for a in axes))
                rms = torch.sqrt(mean(u * u, None, every) + 1e-12)
                u = u / torch.clamp(rms, min=1.0)
                m32 = m.float() * self.b1 + u * (1 - self.b1)
                step = m32
                if p.ndim >= 2 and self.weight_decay:
                    step = step + self.weight_decay * p.float()
                p.copy_(p.float() - lr * step)
                m.copy_(m32)
                for key, t in new_v.items():
                    v[key].copy_(t)
        return params, {"m": state["m"], "v": state["v"], "count": count}


def make_optimizer(cfg, total_steps: int = 10_000, base_lr: float = 3e-4):
    lr = warmup_cosine(base_lr, warmup=min(500, total_steps // 10 + 1),
                       total=total_steps)
    kind = cfg.optimizer if hasattr(cfg, "optimizer") else cfg
    if kind == "adamw":
        return AdamW(lr=lr)
    if kind == "adamw_bf16":
        return AdamW(lr=lr, moment_dtype=torch.bfloat16)
    if kind == "adafactor":
        return Adafactor(lr=lr)
    raise ValueError(f"unknown optimizer {kind!r}")
