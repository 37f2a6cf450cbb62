"""Percent of the chip's bf16 peak that a prefill reaches in model FLOPs
(``reference.flops.prefill_flops``: 2 a matmul weight a prompt token, the
embedding lookup not counted and the head at each prompt's last position
only, plus attention's causal half or the SSD recurrence) over the
window's median time to first token, against 989 TFLOP/s."""

import statistics

from reference import flops, peaks


def read(r):
    if r.get("kind") != "serve":
        return None
    tr = r["traffic"]
    need = flops.prefill_flops(r["cfg"], tr["batch"], tr["prompt"])
    t = statistics.median(r["window"]["ttft_s"])
    return 100 * need / t / (peaks.BF16_FLOPS * r["chips"])
