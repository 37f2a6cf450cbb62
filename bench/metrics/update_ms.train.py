"""Device milliseconds of a train step's update phase: CUDA events at the
step's phase hook, from "optimizer" to the step's end, the mean over the
traced steps.  It holds the contributions' sums, the global norm, the
guard's host read and AdamW."""


def read(r):
    ms = r.get("phases", {}).get("optimizer")
    return sum(ms) / len(ms) if ms else None
