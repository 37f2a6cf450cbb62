"""Host milliseconds of one decode step of the window's requests: every
request's decode time (``ServeEngine.stats["decode_s"]``: from its first
tokens picked, ended by a synchronise, to the end of its last decode step,
ended by one), summed, over the number of decode steps (``new_tokens`` a
request)."""


def read(r):
    if r.get("kind") != "serve" or not r["window"]["decode_steps"]:
        return None
    w = r["window"]
    return 1e3 * sum(w["decode_s"]) / w["decode_steps"]
