"""Train-step construction: loss, gradient accumulation, optimizer update
(mirrors ``repro/train/step.py``, the single-device ``build_train_step``).

``build_train_step`` returns a ``(state, batch) -> (state, metrics)``
function:

- fp32 softmax cross-entropy over the logits + the MoE auxiliary loss (0
  until MoE is ported) + z-loss;
- microbatch gradient accumulation (``cfg.grad_accum``), a Python loop into
  an ``accum_dtype`` accumulator where the reference scans;
- optional gradient compression (a bf16 round trip);
- global-norm clipping folded into the optimizer's fp32 cast as ``scale``,
  then the optimizer update, in place (``optim/optimizers.py``);
- the non-finite guard (``resilience/guard.py``): the one-bit flag is read
  on the host before the update, which runs only on a clean step.

Gradients come from ``torch.autograd.grad`` through the model's forward in
train mode, whose kernels (``kernels/ops.py``) recompute their backward
through their plain versions, as the reference's ``custom_vjp``s do.  The
hybrid and pipeline builders wait for ROADMAP Queue 1 items 5-6.
"""

from __future__ import annotations

import torch

from repro_torch.models import forward
from repro_torch.models.model import DTYPES
from repro_torch.optim.optimizers import global_norm
from repro_torch.resilience.guard import apply_guard, nonfinite_flag


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean token cross-entropy in fp32 (+ z-loss on the partition fn)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (lse - ll).mean()
    return nll + z_loss * (lse ** 2).mean(), nll


def build_loss_fn(cfg, aux_weight: float = 0.01):
    def loss_fn(params, batch):
        logits, _, aux = forward(params, batch, cfg, mode="train")
        loss, nll = cross_entropy(logits, batch["labels"])
        total = loss + aux_weight * aux
        return total, {"nll": nll, "aux": aux}
    return loss_fn


def batch_to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch arrays as tensors on ``device``; integer
    arrays become int64 (the index type of the gather and the loss)."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        out[name] = t.to(device, t.dtype if t.is_floating_point()
                         else torch.long)
    return out


def loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, {name: grad}) of ``loss_fn(params, batch)``, all
    detached; ``params`` themselves are not marked as requiring grad."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, metrics = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def build_train_step(cfg, optimizer, *, aux_weight: float = 0.01,
                     max_grad_norm: float = 1.0, grad_compress: bool = False,
                     accum_dtype=None, nonfinite_guard: bool = True,
                     fault_hook=None):
    """``accum_dtype``: name of the microbatch gradient accumulator's dtype
    (default ``cfg.accum_dtype``), used when ``cfg.grad_accum > 1``.

    ``nonfinite_guard`` (default on): when the loss or any gradient is
    non-finite the update does not run: params and moments stay bitwise
    unchanged, ``skipped_steps`` increments, ``step`` still advances.
    ``fault_hook`` (``grads -> grads``) is the injection point for tests.
    The state's params are updated in place on a clean step."""
    loss_fn = build_loss_fn(cfg, aux_weight)
    accum = max(cfg.grad_accum, 1)
    accum_dtype = DTYPES[accum_dtype or cfg.accum_dtype]

    def train_step(state, batch):
        params = state["params"]
        batch = batch_to_device(batch, params["embed"].device)
        if accum > 1:
            mbs = {k: x.reshape((accum, x.shape[0] // accum) + x.shape[1:])
                   for k, x in batch.items()}
            loss = torch.zeros((), device=params["embed"].device)
            grads = {k: torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device)
                     for k, p in params.items()}
            mets = []
            for i in range(accum):
                loss_i, met, grads_i = loss_and_grads(
                    loss_fn, params, {k: x[i] for k, x in mbs.items()})
                for k, g in grads_i.items():
                    grads[k] += g.to(accum_dtype)
                loss = loss + loss_i
                mets.append(met)
            loss = loss / accum
            grads = {k: g / accum for k, g in grads.items()}
            metrics = {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}
        else:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)

        if grad_compress:
            # wire-format compression for the DP all-reduce (bf16)
            grads = {k: g.to(torch.bfloat16).float() for k, g in grads.items()}
        if fault_hook is not None:
            grads = fault_hook(grads)

        # fold the clip scale into the optimizer's fp32 cast: no clipped
        # copy of the gradients is made
        gnorm = global_norm(grads)
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        if nonfinite_guard:
            flag = int(nonfinite_flag((loss, grads)))   # the host decides
            new_params, new_opt = params, state["opt"]
            if not flag:
                new_params, new_opt = optimizer.update(
                    grads, state["opt"], params, scale=scale)
            new_state = apply_guard(flag, state, new_params, new_opt)
            metrics["skipped"] = flag
        else:
            new_params, new_opt = optimizer.update(grads, state["opt"],
                                                   params, scale=scale)
            new_state = {"params": new_params, "opt": new_opt,
                         "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def init_train_state(cfg, params, optimizer):
    return {"params": params, "opt": optimizer.init(params), "step": 0,
            "skipped_steps": 0}
