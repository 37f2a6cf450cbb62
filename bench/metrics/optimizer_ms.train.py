"""Device milliseconds a train step launched under the program's span
``optim.update`` (``AdamW.update``: every leaf's update), the mean over the
profiled stretch's steps and over the ranks.  Part of ``update_ms.train``,
which adds the contributions' sums, the global norm and the guard."""

import spans


def read(r):
    us = spans.mean_per(r, "train", "optim.update", "device_us",
                        lambda st: st["steps"])
    return None if us is None else us / 1e3
