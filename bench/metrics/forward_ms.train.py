"""Device milliseconds of a train step's forward: CUDA events at the step's
phase hook, from "forward" to "backward", the mean over the traced steps."""


def read(r):
    ms = r.get("phases", {}).get("forward")
    return sum(ms) / len(ms) if ms else None
