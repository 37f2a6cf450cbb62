"""Operations and bytes of one call of each hand-written kernel of the port.

A frozen copy of the program's own count (its ``kernels/cost.py``), kept
here so that a change to the program cannot move the bound a roofline share
is measured against.  Shapes are plain tuples; ``dtype`` a ``torch.dtype`` or
its name.
"""

from __future__ import annotations

import torch


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(torch, str(dtype).removeprefix("torch.")).itemsize


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def kernel_cost(name: str, *shapes, dtype, causal: bool = True,
                chunk: int = 64, w_dtype=torch.float32) -> dict:
    """Operations and bytes of ONE call of a hand-written kernel: each
    input read once, each output written once, and the operations the
    call does.

    - ``flash_attention``, shapes q (B, Sq, H, hd), k, v (B, Skv, KH, hd):
      bytes q, k, v and the output; 4 B H hd operations per (query, key)
      pair it computes: every pair, or under ``causal`` the kernel's
      top-left triangle (query i sees keys 0..i).
    - ``rmsnorm``, shapes x (..., d), w (d,) (``w_dtype``): bytes x, w
      and y; 4 operations per element.
    - ``ssd_scan``, shapes x (B, S, H, P), dt, a_neg, Bm (B, S, N), Cm:
      bytes x, B, C, y in ``dtype``, dt, a_neg and the fp32 final state;
      per (batch, chunk of L = min(chunk, S)) C B^T (2 L^2 N), and per
      head and chunk the intra product (2 L^2 P), the inter product and
      the state update (2 L N P each).
    """
    size = _itemsize(dtype)
    if name == "flash_attention":
        q, k = shapes[0], shapes[1]
        B, Sq, H, hd = q
        Skv = k[1]
        if causal:
            n = min(Sq, Skv)
            pairs = n * (n + 1) // 2 + (Sq - n) * Skv
        else:
            pairs = Sq * Skv
        return {"flops": 4 * B * H * hd * pairs,
                "bytes": size * (2 * _numel(q) + 2 * _numel(k))}
    if name == "rmsnorm":
        x, w = shapes[0], shapes[1]
        return {"flops": 4 * _numel(x),
                "bytes": 2 * size * _numel(x)
                + _itemsize(w_dtype) * _numel(w)}
    if name == "ssd_scan":
        B, S, H, P = shapes[0]
        N = shapes[3][-1]
        L = min(chunk, S)
        nc = -(-S // L)
        return {"flops": B * nc * 2 * L * L * N
                + B * H * nc * (2 * L * L * P + 4 * L * N * P),
                "bytes": 2 * size * B * S * H * P + 4 * B * S * H + 4 * H
                + 2 * size * B * S * N + 4 * B * H * P * N}
    raise ValueError(f"kernel_cost: no kernel {name!r}")
