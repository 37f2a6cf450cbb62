"""Hand-written Hopper kernels for the compute hot spots: flash attention
and the Mamba2 SSD chunk scan (CUDA C++; bf16 on the tensor cores,
``csrc/*_tc.cu``, fp32 on the CUDA cores, ``csrc/flash_attention.cu`` and
``csrc/ssd_scan.cu``) and RMSNorm (Triton).  Each has a plain PyTorch
version (``ref.py``, the chunked scan ``ref.ssd_chunked`` among them)
and a device-dispatching wrapper in ``ops.py``; ``build.py`` compiles the
CUDA sources on first use."""

from . import ops, ref  # noqa: F401
