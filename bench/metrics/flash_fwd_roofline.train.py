"""Percent of its roofline that the flash attention forward reaches in the
traced stretch: the least time of every call (the frozen kernel_cost at
the call's shapes, causal) over the device time of the kernels named
below.  Under remat a train step makes each layer's call twice."""

import harness

KERNELS = ("flash_tc_kernel", "flash_tf32x3_kernel")


def read(r):
    return harness.roofline_share(r, "train", "flash_attention", KERNELS,
                                  causal=True)
