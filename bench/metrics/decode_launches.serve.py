"""Device operations (kernels, copies, sets) a decode step launched under
the program's span ``serve.decode_step``, over the profiled stretch's
decode steps (its requests times ``new_tokens``), the mean over the
ranks."""

import spans


def read(r):
    return spans.mean_per(r, "serve", "serve.decode_step", "launches",
                          lambda st: st["requests"]
                          * r["traffic"]["new_tokens"])
