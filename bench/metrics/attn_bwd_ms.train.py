"""Device milliseconds a train step launched under the program's span
``kernels.flash_attention.bwd``: the flash kernel's backward, recomputed
through the plain blockwise attention and its ``autograd.grad`` (on the
autograd engine's thread), the mean over the profiled stretch's steps and
over the ranks.  Part of ``backward_ms.train``."""

import spans


def read(r):
    us = spans.mean_per(r, "train", "kernels.flash_attention.bwd",
                        "device_us", lambda st: st["steps"])
    return None if us is None else us / 1e3
