"""Hand-written Hopper kernels for the compute hot spots: flash attention
(CUDA C++, ``csrc/flash_attention.cu``), RMSNorm (Triton) and the Mamba2
SSD chunk scan (CUDA C++, ``csrc/ssd_scan.cu``).  Each has a plain PyTorch
version (``ref.py``; the chunked scan is ``models/ssm.py::ssd_chunked``)
and a device-dispatching wrapper in ``ops.py``; ``build.py`` compiles the
CUDA sources on first use."""

from . import ops, ref  # noqa: F401
