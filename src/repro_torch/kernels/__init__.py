"""Hand-written Hopper kernels for the compute hot spots: flash attention
(CUDA C++, ``csrc/flash_attention.cu``) and RMSNorm (Triton).  Each has a
plain PyTorch version in ``ref.py`` and a device-dispatching wrapper in
``ops.py``; ``build.py`` compiles the CUDA sources on first use."""

from . import ops, ref  # noqa: F401
