"""Serving engine: batched prefill + decode against preallocated caches
(mirrors ``repro/serve/engine.py``).

``prefill`` runs the full forward over the prompt and copies the layer
caches into preallocated buffers: K/V into the first S positions of the
max-length buffers, the conv and SSM states whole.  ``decode_step`` appends
one token for the whole batch, writing its K/V and the new states into those
buffers in place (the reference donates the cache and returns an updated
copy).  The batch
advances in lockstep (one shared cache_len).

With a ``policy`` over a (data, model) mesh the engine serves sharded
(``models.forward(..., policy=)``): every rank of the mesh builds it with
its own shards of the parameters (``models.shard_params`` or
``models.init_rank_params``) and calls it together.  The batch splits over
``data``, the heads and d_ff over ``model``, and the cache by
``policy.kv_layout`` (``kvdim``: head_dim over ``model``; ``kvseq``: the
sequence).  ``prefill`` takes the global prompt, the same on every rank,
and returns this rank's rows; ``decode_step`` takes and returns this
rank's rows; ``generate`` returns the global tokens, gathered over
``data``.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core import primitives as prim
from repro_torch.models import forward, init_cache
from repro_torch.models.blocks import check_serve_policy
from repro_torch.tracing import span


class ServeEngine:
    def __init__(self, cfg, params, policy=None, *, max_seq: int,
                 batch_size: int):
        if policy is not None:
            check_serve_policy(cfg, policy)
        self.cfg = cfg
        self.params = params
        self.policy = policy
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.device = params["embed"].device
        self.stats = {}   # timings and checks of the last generate()

    def _rows(self, tokens):
        """This rank's rows of the global ``tokens`` (all of them without a
        data axis)."""
        ax = self.policy.active_data_axis
        if ax is None:
            return tokens
        with prim.use_mesh(self.policy.mesh):
            return prim.batch_scatter(tokens, ax, 0)

    @torch.inference_mode()
    def prefill(self, tokens):
        """tokens: (B, S_prompt) -> (last_logits, cache); with a policy,
        the last logits of this rank's rows and its part of the cache.
        The span ``serve.prefill``."""
        with span("serve.prefill"):
            return self._prefill(tokens)

    def _prefill(self, tokens):
        cache = init_cache(self.cfg, self.batch_size, self.max_seq,
                           device=self.device, policy=self.policy)
        if self.policy is not None:
            logits, cache, _ = forward(self.params,
                                       {"tokens": self._rows(tokens)},
                                       self.cfg, mode="prefill", cache=cache,
                                       policy=self.policy)
            return logits[:, -1], cache
        logits, pref_cache, _ = forward(self.params, {"tokens": tokens},
                                        self.cfg, mode="prefill")
        S = tokens.shape[1]
        for name, leaf in pref_cache.items():
            if name.endswith((".k", ".v")):
                cache[name][:, :, :S] = leaf
            else:   # conv / SSM state: the prompt's final state, whole
                cache[name].copy_(leaf)
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode_step(self, cache, tokens, cache_len: int):
        """tokens: (B, 1); cache_len: the number of positions already cached.
        Updates ``cache`` in place and returns (last_logits, cache).  The
        span ``serve.decode_step``."""
        batch = {"tokens": tokens, "cache_len": cache_len}
        with span("serve.decode_step"):
            logits, cache, _ = forward(self.params, batch, self.cfg,
                                       mode="decode", cache=cache,
                                       policy=self.policy)
        return logits[:, -1], cache

    @torch.inference_mode()
    def generate(self, prompt, steps: int, *, greedy: bool = True,
                 generator=None, temperature: float = 1.0):
        """Greedy / temperature sampling for ``steps`` tokens -> (B, steps),
        the global rows with a policy.

        Records in ``self.stats`` the seconds of the prefill (first token
        included) and of the decode steps, each ended by a device
        synchronise, and whether every logit this rank read was finite.
        """
        S = prompt.shape[1]
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompt)
        finite = torch.isfinite(logits).all()
        tok = self._pick(logits, greedy, generator, temperature)
        self._sync()
        t1 = time.perf_counter()
        out = []
        for t in range(steps):
            out.append(tok)
            logits, cache = self.decode_step(cache, tok, S + t)
            finite &= torch.isfinite(logits).all()
            tok = self._pick(logits, greedy, generator, temperature)
        self._sync()
        t2 = time.perf_counter()
        self.stats = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                      "logits_finite": bool(finite)}
        out = torch.cat(out, dim=1)
        ax = self.policy.active_data_axis if self.policy is not None else None
        if ax is not None:
            with prim.use_mesh(self.policy.mesh):
                out = prim.all_gather(out, ax, 0)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _pick(logits, greedy, generator, temperature):
        if greedy:
            return torch.argmax(logits, dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
