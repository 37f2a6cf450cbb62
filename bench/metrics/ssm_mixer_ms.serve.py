"""Device milliseconds a prefill launched under the program's spans
``serve.prefill`` / ... / ``model.ssm``: every SSM mixer of the prompt's
forward (projections, conv, gates, the SSD kernel, the gated norm), over
the profiled stretch's requests (one prefill each), the mean over the
ranks."""

import spans


def read(r):
    us = spans.mean_per(r, "serve", "model.ssm", "device_us",
                        lambda st: st["requests"], within="serve.prefill")
    return None if us is None else us / 1e3
