"""Percent of the chips' bf16 peak that the window's train steps reach in
model FLOPs (``reference.flops.train_step_flops``: 6 a matmul weight a
token, the head included and the embedding lookup not, plus attention's
causal half or the SSD recurrence, times 3; no recompute) over the
window's seconds, against 989 TFLOP/s a chip."""

from reference import flops, peaks


def read(r):
    if r.get("kind") != "train":
        return None
    w, tr = r["window"], r["traffic"]
    done = flops.train_step_flops(r["cfg"], tr["batch"], tr["seq"]) * w["steps"]
    return 100 * done / w["elapsed_s"] / (peaks.BF16_FLOPS * r["chips"])
