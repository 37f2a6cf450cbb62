"""The window loop of a serving cell: the port's ``serve.engine.
ServeEngine`` on one card, driven request by request by one closed-loop
client through ``ServeEngine.generate``, the entry point users call.

A request is ``batch`` prompts of ``prompt`` tokens, answered greedily
with ``new_tokens`` tokens each: ``generate(prompts, steps=new_tokens)``,
the engine's prefill and the pick of the first token, then its
``new_tokens`` decode steps (the last step's pick is not served), every
step's logits checked finite.  The client sends its next request when the
last one's tokens are on the host.  Its time to first token runs from the
request's start, its prompt formed on the host, through the prompt's copy
to the card, to the first tokens picked, ended by the engine's synchronise
(``stats["prefill_s"]``).  Set-up makes the weights and warms the cell's
shapes with two requests of the same sizes.  The window runs requests until
``--seconds`` have passed; ``serve_tokens_per_s`` is the prompt and served
tokens of every request over the time to the last answer.  After the window
(``--trace 1``) two requests run under the profiler.

The comparison: a sample of the window's requests, drawn from the seed,
each prompt with its served tokens run through the float32 reference
once, and the served tokens' gaps below the reference's best logit.
"""

from __future__ import annotations

import gc

import numpy as np
import torch
from repro_torch.serve.engine import ServeEngine

import harness
from reference import check, model
from reference.inputs import make_weights, prompts

WARMUP = 2


class Client:
    """One client of the engine: ``request(r)`` sends request ``r`` and
    returns its served tokens (batch, new_tokens) and its timings."""

    def __init__(self, engine, tr, conf, seed, device):
        self.engine, self.tr, self.conf = engine, tr, conf
        self.seed, self.device = seed, device

    def request(self, r: int) -> dict:
        tr = self.tr
        host = torch.from_numpy(prompts(self.seed, r, tr["batch"],
                                        tr["prompt"], self.conf["vocab_size"]))
        with torch.inference_mode():
            t0 = harness.now()
            prompt = host.to(self.device)
            t1 = harness.now()
            tokens = self.engine.generate(prompt, tr["new_tokens"]).cpu()
            end = harness.now()
        stats = self.engine.stats
        return {"tokens": tokens.numpy(),
                "ttft_s": t1 - t0 + stats["prefill_s"],
                "decode_s": stats["decode_s"],
                "finite": stats["logits_finite"], "end": end}


def run(cell: harness.Cell, run: harness.Run) -> dict:

    conf, tr, dev = cell.config, cell.traffic, run.device
    B, P, N, V = tr["batch"], tr["prompt"], tr["new_tokens"], \
        conf["vocab_size"]
    stages = harness.Stages(run.t0)
    weights = make_weights(conf, run.seed, dev)
    stages("weights")
    engine = ServeEngine(harness.program_config(conf), weights, max_seq=P + N,
                         batch_size=B)
    engine = run.faults.get("engine", lambda e: e)(engine)
    client = Client(engine, tr, conf, run.seed, dev)
    for w in range(WARMUP):
        client.request(-1 - w)
    stages("warmup")

    harness.sync(dev)
    t_w = harness.now()
    setup_s = t_w - run.t0
    done = []
    while harness.now() - t_w < run.seconds:
        done.append(client.request(len(done)))
    elapsed = done[-1]["end"] - t_w
    bad = sum(int(not d["finite"] or ((d["tokens"] < 0)
                                       | (d["tokens"] >= V)).any())
              for d in done)
    ttft = [d["ttft_s"] for d in done]
    h = len(done) // 2
    halves = [h * B * (P + N) / (done[h - 1]["end"] - t_w),
              (len(done) - h) * B * (P + N) / (done[-1]["end"]
                                                - done[h - 1]["end"])] \
        if h else []
    out = {"attempted": len(done), "failed": bad,
           "notes": {"stages": stages.marks,
                     "serve_tokens_per_s_halves": halves},
           "e2e": {"ttft_p95_ms": harness.percentile(ttft, 95) * 1e3,
                   "serve_tokens_per_s": len(done) * B * (P + N) / elapsed,
                   "setup_s": setup_s},
           "readings": {"kind": "serve", "chips": cell.chips, "cfg": conf,
                        "traffic": tr,
                        "window": {"requests": len(done), "elapsed_s": elapsed,
                                   "ttft_s": ttft,
                                   "decode_s": [d["decode_s"] for d in done],
                                   "decode_steps": len(done) * N}}}

    if run.trace:
        def stretch():
            for r in range(2):
                client.request(len(done) + r)

        st = harness.profile_stretch(stretch, run.tmp)
        st["requests"] = 2
        out["readings"]["stretches"] = [st]
        out["device_extra"] = harness.device_seconds([st])
        out["breakdown"] = harness.breakdown(st)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    del engine, client
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = np.random.default_rng((run.seed & ((1 << 64) - 1), 2)).choice(
        len(done), size=min(tr["check_requests"], len(done)), replace=False)
    gap = max(reference_gap(conf, tr, weights, run.seed, int(r),
                            done[r]["tokens"], dev)["gap"]
              for r in sorted(sample))
    out["checks"] = harness.checks({"served_gap": gap}, cell.limits)
    return out


def reference_gap(conf, tr, weights, seed, r, served, dev,
                  control: bool = False) -> dict:
    """Request ``r``'s prompts with their ``served`` tokens (batch,
    new_tokens) through the float32 reference: the widest gap of a served
    token below the reference's best logit; with ``control`` also the
    widest gap of the token the fp8 control puts first."""
    P = tr["prompt"]
    seq = np.concatenate([prompts(seed, r, tr["batch"], P,
                                  conf["vocab_size"]), served[:, :-1]], 1)
    seq = torch.from_numpy(seq).to(dev)
    served = torch.from_numpy(served).to(dev)
    positions = torch.arange(P - 1, P - 1 + served.shape[1], device=dev)
    with harness.fp32():
        ref = model.logits_at(weights, seq, positions, conf)
        out = {"gap": check.served_gap(ref, served)}
        if control:
            low = model.logits_at(weights, seq, positions, conf, mm=model.mm8)
            out["control_gap"] = check.served_gap(ref, low.argmax(dim=-1))
    return out
