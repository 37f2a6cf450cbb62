"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit), and the least time a kernel call could take on it.

Every share the benchmark reports is stated against these numbers; the
run prints the card's power limit beside them (``device.power_limit_w``).
"""

from __future__ import annotations

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
TF32_FLOPS = 494.5e12      # TF32 tensor cores
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12      # HBM3

# The rate a route's operations are bounded by: bf16 kernels on the bf16
# tensor cores; the fp32 ``tf32x3`` kernels do three TF32 passes a product.
ROUTE_FLOPS = {"tensor_core": BF16_FLOPS, "tf32x3": TF32_FLOPS / 3}


def bound_s(cost: dict, route: str = "tensor_core") -> float:
    """The larger of operations over the route's peak rate and bytes over
    the HBM bandwidth: the least time the call could take."""
    return max(cost["flops"] / ROUTE_FLOPS[route],
               cost["bytes"] / HBM_BYTES_S)
