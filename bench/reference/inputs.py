"""The benchmark's inputs, made from ``--seed`` alone: the weights (on the
card, one ``torch.Generator`` and one draw a leaf, in the type they are
served in) and the traffic (token streams and prompts, on the host).

The same seed gives the same inputs.  Both sides of a comparison are handed
these: the program takes the weights as its parameters, and the reference
converts them to float32 itself.  The token stream is a frozen copy of the
program's synthetic stream (``data/pipeline.py::SyntheticLM``): noisy
modular-arithmetic rows, each row a pure function of (seed, row).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK64 = (1 << 64) - 1


def _mix(*words: int) -> int:
    """splitmix64 over ``words``: a 63-bit seed for one generator."""
    z = 0x9E3779B97F4A7C15
    for w in words:
        z = (z ^ (int(w) & MASK64)) & MASK64
        z = (z + 0x9E3779B97F4A7C15) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z >> 1


def leaf_specs(cfg) -> dict:
    """``{name: (shape, init, scale)}`` of every parameter, in the port's
    layout: flat names, layers stacked on a leading dim, weights
    ``(d_in, d_out)``.  ``init`` is ``normal`` (N(0, scale^2), served in
    the configuration's dtype), or, held in float32, ``ones``, ``zeros``,
    ``log_uniform`` (uniform in [0, scale)), ``log_of_uniform`` (the log
    of a draw uniform in ``scale``, a range) or ``dt_bias`` (softplus's
    inverse of a step drawn log-uniform in ``scale``, a range).

    The configuration's ``init`` may set the published recipe in place of
    the port's (N(0, 1/d_in) weights and embedding rows, A log-uniform in
    [1, 16), dt_bias 0): ``embed_std``, ``weight_std`` (a factor on
    1/sqrt(d_in), on the conv's 1/sqrt(kernel) too), ``residual_divisor``
    (the output projections that write the residual, divided by the square
    root of the number of layers times it), ``a_range`` and ``dt_range``."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    init = cfg.get("init", {})
    factor = init.get("weight_std", 1.0)
    res = init.get("residual_divisor")
    out_factor = factor / math.sqrt(res * L) if res else factor

    def w(d_in, d_out, f=factor):
        return ((L, d_in, d_out), "normal", f / math.sqrt(d_in))

    out = {"embed": ((V, d), "normal", init.get("embed_std", 1 / math.sqrt(V))),
           "norm_final": ((d,), "ones", 1.0)}
    if not cfg.get("tie_embeddings"):
        out["lm_head"] = ((d, V), "normal", 1 / math.sqrt(d))
    b = "blocks.pos0."
    out[b + "norm_mixer"] = ((L, d), "ones", 1.0)
    if cfg["num_heads"]:
        H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        out.update({b + "attn.wq": w(d, H * hd), b + "attn.wk": w(d, KH * hd),
                    b + "attn.wv": w(d, KH * hd),
                    b + "attn.wo": w(H * hd, d, out_factor)})
    else:
        din = cfg["ssm_expand"] * d
        nh, N, k = din // cfg["ssm_head_dim"], cfg["ssm_state"], \
            cfg["conv_kernel"]
        out.update({
            b + "ssm.in_z": w(d, din), b + "ssm.in_x": w(d, din),
            b + "ssm.in_B": w(d, N), b + "ssm.in_C": w(d, N),
            b + "ssm.in_dt": w(d, nh),
            b + "ssm.conv_w": ((L, k, din), "normal", factor / math.sqrt(k)),
            b + "ssm.a_log": (((L, nh), "log_of_uniform", init["a_range"])
                              if "a_range" in init else
                              ((L, nh), "log_uniform", math.log(16.0))),
            b + "ssm.d_skip": ((L, nh), "ones", 1.0),
            b + "ssm.dt_bias": (((L, nh), "dt_bias", init["dt_range"])
                                if "dt_range" in init else
                                ((L, nh), "zeros", 0.0)),
            b + "ssm.ssm_norm": ((L, din), "ones", 1.0),
            b + "ssm.out_proj": w(din, d, out_factor)})
    if cfg.get("d_ff"):
        ff = cfg["d_ff"]
        out[b + "norm_ffn"] = ((L, d), "ones", 1.0)
        out.update({b + "mlp.w_up": w(d, ff), b + "mlp.w_gate": w(d, ff),
                    b + "mlp.w_down": w(ff, d, out_factor)})
    return out


def make_leaf(cfg, name: str, seed: int, device, dtype=None):
    """One leaf of the weights: the same values for the same seed, on its
    own, whichever leaves are made beside it.  ``dtype`` overrides the
    served type of a ``normal`` leaf."""
    shape, init, scale = leaf_specs(cfg)[name]
    if init in ("ones", "zeros"):
        return torch.full(shape, float(init == "ones"), dtype=torch.float32,
                          device=device)
    names = sorted(leaf_specs(cfg))
    gen = torch.Generator(device=device).manual_seed(
        _mix(seed, names.index(name)))
    if init == "log_uniform":
        return torch.rand(shape, generator=gen, device=device) * scale
    if init == "log_of_uniform":
        lo, hi = scale
        return torch.log(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                     device=device))
    if init == "dt_bias":
        lo, hi = math.log(scale[0]), math.log(scale[1])
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                   device=device))
        return dt + torch.log(-torch.expm1(-dt))
    served = getattr(torch, cfg["dtype"])
    out = torch.randn(shape, generator=gen, device=device, dtype=served)
    out.mul_(scale)
    return out if dtype is None else out.to(dtype)


def make_weights(cfg, seed: int, device) -> dict:
    return {name: make_leaf(cfg, name, seed, device)
            for name in leaf_specs(cfg)}


def train_batch(seed: int, step: int, batch: int, seq: int,
                vocab: int) -> dict:
    """Rows ``step * batch ..`` of the seeded token stream: ``tokens`` and
    their next-token ``labels``, (batch, seq) int32 each."""
    seed &= MASK64
    drift = 1 + (seed % max(vocab - 1, 1))
    rows = []
    for r in range(batch):
        rng = np.random.default_rng((seed, step * batch + r))
        start = rng.integers(0, vocab)
        row = (start + drift * np.arange(seq + 1)) % vocab
        noise = rng.random(seq + 1) < 0.02
        rows.append(np.where(noise, rng.integers(0, vocab, seq + 1), row))
    tok = np.stack(rows).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def prompts(seed: int, request: int, batch: int, length: int,
            vocab: int) -> np.ndarray:
    """The ``batch`` prompts of request ``request``: tokens uniform over the
    vocabulary, (batch, length) int64.  Negative ``request`` numbers are the
    warm-up's, which no measured request uses."""
    rng = np.random.default_rng((seed & MASK64, 1, request & MASK64))
    return rng.integers(0, vocab, (batch, length), dtype=np.int64)
