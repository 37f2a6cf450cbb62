"""Percent of the traced stretch in which no device operation ran: 1 less
the union of the device's kernels, copies and sets over the stretch's span
on the host.  NCCL kernels count as busy."""

import harness


def read(r):
    return harness.idle_share(r, "train")
