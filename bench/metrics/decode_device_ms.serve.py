"""Device milliseconds a decode step launched under the program's span
``serve.decode_step`` (``ServeEngine.decode_step``: one token's forward
against the caches), over the profiled stretch's decode steps (its
requests times ``new_tokens``), the mean over the ranks.  Against
``decode_step_ms.serve``, the host's time a step."""

import spans


def read(r):
    us = spans.mean_per(r, "serve", "serve.decode_step", "device_us",
                        lambda st: st["requests"]
                        * r["traffic"]["new_tokens"])
    return None if us is None else us / 1e3
