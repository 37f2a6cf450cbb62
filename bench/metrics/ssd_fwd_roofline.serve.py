"""Percent of its roofline that the SSD scan forward reaches in the traced
stretch: the least time of every call (the frozen kernel_cost at the
call's shapes, chunks of 64) over the device time of the kernels named
below."""

import harness

KERNELS = ("ssd_tc_kernel", "ssd_tf32x3_kernel")


def read(r):
    return harness.roofline_share(r, "serve", "ssd_scan", KERNELS, chunk=64)
