"""Serving engine: batched prefill + decode against preallocated caches
(mirrors ``repro/serve/engine.py``).

``prefill`` runs the full forward over the prompt and copies the layer
caches into preallocated max-length buffers; ``decode_step`` appends one
token for the whole batch, writing its K/V into those buffers in place
(the reference donates the cache and returns an updated copy).  The batch
advances in lockstep (one shared cache_len).
"""

from __future__ import annotations

import time

import torch

from repro_torch.models import forward, init_cache


class ServeEngine:
    def __init__(self, cfg, params, *, max_seq: int, batch_size: int):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.device = params["embed"].device
        self.stats = {}   # timings and checks of the last generate()

    @torch.inference_mode()
    def prefill(self, tokens):
        """tokens: (B, S_prompt) -> (last_logits, cache)."""
        logits, pref_cache, _ = forward(self.params, {"tokens": tokens},
                                        self.cfg, mode="prefill")
        cache = init_cache(self.cfg, self.batch_size, self.max_seq,
                           device=self.device)
        S = tokens.shape[1]
        for name, kv in pref_cache.items():
            cache[name][:, :, :S] = kv
        return logits[:, -1], cache

    @torch.inference_mode()
    def decode_step(self, cache, tokens, cache_len: int):
        """tokens: (B, 1); cache_len: the number of positions already cached.
        Updates ``cache`` in place and returns (last_logits, cache)."""
        batch = {"tokens": tokens, "cache_len": cache_len}
        logits, cache, _ = forward(self.params, batch, self.cfg,
                                   mode="decode", cache=cache)
        return logits[:, -1], cache

    @torch.inference_mode()
    def generate(self, prompt, steps: int, *, greedy: bool = True,
                 generator=None, temperature: float = 1.0):
        """Greedy / temperature sampling for ``steps`` tokens -> (B, steps).

        Records in ``self.stats`` the seconds of the prefill (first token
        included) and of the decode steps, each ended by a device
        synchronise, and whether every logit read was finite.
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
        return torch.cat(out, dim=1)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _pick(logits, greedy, generator, temperature):
        if greedy:
            return torch.argmax(logits, dim=-1, keepdim=True)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
