"""The plain reference of the benchmark's models: float32 PyTorch, no
kernel, cache or batching trick, written from the models' equations.

It takes the weights the benchmark made (``inputs.make_weights``, in the
port's layout) and converts each to float32 as it uses it.  It imports
nothing of the program.

The architecture is the one the port implements, which departs from the
published models where noted in ``PERF.md``: GLM-4's attention without
the QKV bias and with RoPE over the whole head dim; Mamba-2's depthwise
conv over x alone (B and C unconvolved), one group of B and C.

Per layer: ``x + mixer(rmsnorm(x))``, then ``x + mlp(rmsnorm(x))`` where
the model has an MLP.  Attention: q, k, v projections, RoPE on q and k
(rotating pairs (i, i + hd/2), angles in float64), causal softmax
attention, query head h reading K/V head h // (H / KH), the output
projection.  MLP: SwiGLU, ``(silu(x Wg) * (x Wu)) Wd``.  Mamba-2: z, x, B,
C and dt projections; ``silu`` of the causal depthwise conv of x; ``dt =
softplus(dt + dt_bias)``, ``A = -exp(a_log)``; the recurrence ``h_t =
exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t + D x_t``;
``rmsnorm(y * silu(z))``; the output projection.  Then the final RMSNorm
and the head (the embedding's transpose where tied).  RMSNorm's epsilon is
1e-6.

``mm`` is the one matmul every weight goes through: ``mm32`` for the
reference, ``mm8`` for the control, which rounds both operands to fp8
(e4m3, one scale a tensor) before the float32 product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
E4M3_MAX = 448.0
PREFIX = "blocks.pos0."


def mm32(x, w):
    return x @ w


class _RoundFP8(torch.autograd.Function):
    """Round to fp8 e4m3 with one scale for the tensor; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def mm8(x, w):
    return _RoundFP8.apply(x) @ _RoundFP8.apply(w)


def rmsnorm(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w


def rope(x, theta: float):
    """x: (B, S, H, hd), positions 0 .. S - 1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v):
    """Causal attention; q (B, S, H, hd), k and v (B, S, KH, hd)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attn_mixer(p, h, cfg, mm):
    B, S, _ = h.shape
    H, KH, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = rope(mm(h, p["attn.wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rope(mm(h, p["attn.wk"]).reshape(B, S, KH, hd), cfg["rope_theta"])
    v = mm(h, p["attn.wv"]).reshape(B, S, KH, hd)
    return mm(attention(q, k, v).reshape(B, S, H * hd), p["attn.wo"])


def ssd(x, dt, A, Bm, Cm, chunk: int = 128):
    """The Mamba-2 recurrence over a whole sequence, a chunk of positions at
    a time: within a chunk its closed form, across chunks the carried
    state.  x (B, S, H, P), dt (B, S, H), A (H,), Bm and Cm (B, S, N)."""
    Bb, S, H, P = x.shape
    h = x.new_zeros(Bb, H, P, Bm.shape[-1])
    out = torch.empty_like(x)
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        xc, dc, bc, cc = x[:, s0:s1], dt[:, s0:s1], Bm[:, s0:s1], Cm[:, s0:s1]
        a = torch.cumsum(dc * A, dim=1)                  # (B, L, H)
        L = s1 - s0
        keep = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
        diff = (a[:, :, None, :] - a[:, None, :, :]).masked_fill(
            ~keep[None, :, :, None], float("-inf"))
        w = torch.exp(diff) * (cc @ bc.transpose(1, 2))[..., None] \
            * dc[:, None, :, :]                           # (B, t, s, H)
        y = torch.einsum("btsh,bshp->bthp", w, xc)
        y = y + torch.einsum("btn,bhpn->bthp", cc, h) * torch.exp(a)[..., None]
        tail = torch.exp(a[:, -1:, :] - a) * dc           # (B, L, H)
        h = h * torch.exp(a[:, -1])[:, :, None, None] + torch.einsum(
            "bsh,bshp,bsn->bhpn", tail, xc, bc)
        out[:, s0:s1] = y
    return out


def ssm_mixer(p, h, cfg, mm):
    B, S, _ = h.shape
    P = cfg["ssm_head_dim"]
    z = mm(h, p["ssm.in_z"])
    xs = mm(h, p["ssm.in_x"])
    Bm = mm(h, p["ssm.in_B"])
    Cm = mm(h, p["ssm.in_C"])
    dt = F.softplus(mm(h, p["ssm.in_dt"]) + p["ssm.dt_bias"])
    w = p["ssm.conv_w"]                                    # (k, channels)
    k = w.shape[0]
    xp = F.pad(xs, (0, 0, k - 1, 0))
    xs = F.silu(sum(xp[:, i:i + S] * w[i] for i in range(k)))
    xh = xs.reshape(B, S, -1, P)
    y = ssd(xh, dt, -torch.exp(p["ssm.a_log"]), Bm, Cm)
    y = y + p["ssm.d_skip"][:, None] * xh
    y = rmsnorm(y.reshape(B, S, -1) * F.silu(z), p["ssm.ssm_norm"])
    return mm(y, p["ssm.out_proj"])


def layer(p, x, cfg, mm):
    """One layer; ``p`` its float32 weights, names without the
    ``blocks.pos0.`` prefix."""
    h = rmsnorm(x, p["norm_mixer"])
    x = x + (attn_mixer if cfg["num_heads"] else ssm_mixer)(p, h, cfg, mm)
    if cfg.get("d_ff"):
        h = rmsnorm(x, p["norm_ffn"])
        x = x + mm(F.silu(mm(h, p["mlp.w_gate"])) * mm(h, p["mlp.w_up"]),
                   p["mlp.w_down"])
    return x


def head_weight(weights, cfg):
    return weights["embed"].T if cfg.get("tie_embeddings") \
        else weights["lm_head"]


def layer_weights(weights, i: int) -> dict:
    """Layer ``i``'s weights in float32, names without the prefix."""
    return {k[len(PREFIX):]: v[i].float() for k, v in weights.items()
            if k.startswith(PREFIX)}


@torch.no_grad()
def logits_at(weights, tokens, positions, cfg, mm=mm32):
    """The logits (B, len(positions), V) at ``positions`` of the sequences
    ``tokens`` (B, S), layer by layer: one layer's weights in float32 at a
    time."""
    x = weights["embed"][tokens].float()
    for i in range(cfg["num_layers"]):
        x = layer(layer_weights(weights, i), x, cfg, mm)
    x = rmsnorm(x[:, positions], weights["norm_final"].float())
    return mm(x, head_weight(weights, cfg).float())


def loss(params, batch, cfg, mm=mm32, z_loss: float = 1e-4):
    """The training loss of float32 ``params`` (the port's names) on
    ``batch``: the mean next-token cross-entropy plus ``z_loss`` times the
    mean squared log-partition.  A stacked leaf is a tensor with the layers
    on its first dim or a list of the layers' tensors; the activations
    follow each layer's card.  Each layer is recomputed in the backward."""
    from torch.utils.checkpoint import checkpoint
    stacked = {k[len(PREFIX):]: v for k, v in params.items()
               if k.startswith(PREFIX)}
    x = F.embedding(batch["tokens"], params["embed"])

    def one(x, *leaves):
        return layer(dict(zip(stacked, leaves)), x, cfg, mm)

    for i in range(cfg["num_layers"]):
        leaves = [v[i] for v in stacked.values()]
        x = checkpoint(one, x.to(leaves[0].device), *leaves,
                       use_reentrant=False)
    head = head_weight(params, cfg)
    x = x.to(head.device)
    logits = mm(rmsnorm(x, params["norm_final"].to(head.device)), head)
    lse = torch.logsumexp(logits, dim=-1)
    labels = batch["labels"].to(head.device)
    label = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - label).mean() + z_loss * lse.pow(2).mean()
