"""The comparisons that decide ``correct``, and the reference's own
training steps.

Training: the first three steps' losses, the norm of the first step's
gradient as the optimizer gets it (clipped), and the norm of each
parameter's change over the three steps, each taken leaf by leaf and
judged by the worst leaf: the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves under AdamW by round-off alone and
is left out of the change.

Serving: at every served position, how far the served token's logit lies
below the reference's best there; the widest such gap.
"""

from __future__ import annotations

import math
import statistics

import torch

from . import model

STEPS = 3
QUIET_GRAD = 1e-3


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(r, floor)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"loss": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}}``."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                   ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    grad = max(_gap(prog["grad"][k], g, g_med) for k, g in ref["grad"].items())
    moving = [k for k, g in ref["grad"].items() if g >= QUIET_GRAD * g_med]
    c_med = statistics.median(ref["change"][k] for k in moving)
    change = max(_gap(prog["change"][k], ref["change"][k], c_med)
                 for k in moving)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def served_gap(ref_logits, tokens) -> float:
    """``ref_logits`` (..., V) at the served positions, ``tokens`` (...)
    the tokens served there."""
    best = ref_logits.max(dim=-1).values
    got = torch.gather(ref_logits, -1, tokens[..., None])[..., 0]
    return float((best - got).max())


def place(cfg, leaf, devices) -> dict:
    """The float32 parameters from ``leaf(name, device)`` (the benchmark's
    draw, converted here), a layer's leaves on the card it runs on: layer
    i of L on ``devices[i * len(devices) // L]``, the embedding on the
    first, the final norm and the head on the last.  A stacked leaf
    becomes the list of its layers."""
    from .inputs import leaf_specs
    L, first, last = cfg["num_layers"], devices[0], devices[-1]
    out = {}
    for k in leaf_specs(cfg):
        if not k.startswith(model.PREFIX):
            d = first if k == "embed" else last
            out[k] = leaf(k, d).float().requires_grad_()
            continue
        whole = leaf(k, first)
        out[k] = [whole[i].to(devices[i * len(devices) // L]).float()
                  .requires_grad_() for i in range(L)]
        del whole
    return out


def _flat(params: dict) -> list:
    return [(k, t) for k, v in params.items()
            for t in (v if isinstance(v, list) else [v])]


def _norms(pairs, scale=1.0) -> dict:
    """Each leaf's norm, over its layers, from ``(name, tensor)`` pairs."""
    sq = {}
    for k, t in pairs:
        sq[k] = sq.get(k, 0.0) + float(t.double().pow(2).sum())
    return {k: math.sqrt(v) * scale for k, v in sq.items()}


def train_steps(cfg, leaf, batches, opt: dict, *, devices, mm=model.mm32,
                half_batch: bool = False) -> dict:
    """Three AdamW steps of the float32 reference from the weights
    ``leaf(name, device)`` gives, its layers spread over ``devices``
    (``place``), on ``batches`` (tensors on the first).  ``opt``: the
    traffic file's ``lr``, ``b1``, ``b2``, ``eps``, ``weight_decay`` and
    ``clip``.  With ``half_batch`` each step sees the first half of its
    rows only (a fault's reading).  Returns the readings ``train_numbers``
    compares."""
    params = place(cfg, leaf, devices)
    flat = _flat(params)
    m = [torch.zeros_like(p) for _, p in flat]
    v = [torch.zeros_like(p) for _, p in flat]
    b1, b2 = opt["b1"], opt["b2"]
    out = {"loss": []}
    for step in range(1, STEPS + 1):
        batch = batches[step - 1]
        if half_batch:
            rows = batch["tokens"].shape[0] // 2
            batch = {k: t[:rows] for k, t in batch.items()}
        loss = model.loss(params, batch, cfg, mm)
        grads = torch.autograd.grad(loss, [p for _, p in flat])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            norm = math.sqrt(sum(float(g.double().pow(2).sum())
                                 for g in grads))
            scale = min(opt["clip"] / max(norm, 1e-12), 1.0)
            if step == 1:
                out["grad"] = _norms(((k, g) for (k, _), g in
                                      zip(flat, grads)), scale)
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for (k, p), g, mk, vk in zip(flat, grads, m, v):
                g = g * scale
                mk.mul_(b1).add_(g, alpha=1 - b1)
                vk.mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mk / c1) / (torch.sqrt(vk / c2) + opt["eps"])
                if p.ndim >= 2:
                    upd += opt["weight_decay"] * p
                p.sub_(opt["lr"] * upd)
        del grads
    del m, v
    with torch.no_grad():
        start = place(cfg, leaf, devices)
        out["change"] = _norms((k, p - p0) for (k, p), (_, p0) in
                               zip(flat, _flat(start)))
    return out
