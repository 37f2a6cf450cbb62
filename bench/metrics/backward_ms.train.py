"""Device milliseconds of a train step's backward: CUDA events at the
step's phase hook, from "backward" to "optimizer", the mean over the traced
steps."""


def read(r):
    ms = r.get("phases", {}).get("backward")
    return sum(ms) / len(ms) if ms else None
