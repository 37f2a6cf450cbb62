"""Flash attention forward on Hopper: ctypes wrappers of two CUDA kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_fwd`` (``_flash_kernel``).  The kernels are CUDA C++ for
``sm_90a``, built by ``build.py`` with ``nvcc`` and bound with ``ctypes``.

Dispatch is by dtype, a rule and not a fallback (``ROUTES``):

- **bf16** launches ``csrc/flash_attention_tc.cu`` on the tensor cores
  (``wgmma``, TMA loads), the serving route.  P is rounded to bf16 for the
  P V product, which the bf16 pin (2e-2) covers.  A bf16 input it does not
  take (a stride or base TMA cannot address) raises ``ValueError``.
- **fp32** launches ``csrc/flash_attention.cu`` on the TF32 tensor cores
  by split products (``tf32x3``: each operand split into TF32 hi + lo,
  three ``mma.sync`` passes summed in fp32), which holds the reference's
  fp32 pin (2e-5).

A failed build or launch raises ``RuntimeError``.  An empty head block
(H = KH = 0: a rank of a model axis larger than the head count) is a
shape the wrappers take; it has no work, so ``ops`` launches nothing for
it.

Bound: causal prefill at the serving shape (glm4-9b, B=4, S=1024, bf16)
does 34.4 GFLOP on ~71 MB, so it is bound by operations (tensor-core time
~35 us against ~21 us of memory on an H100 SXM).  The design keeps the
S x S scores out of device memory (online softmax over KV tiles in
registers), reads each KV head once per q tile without materialising the
GQA repeat, and skips the tiles above the causal diagonal, halving the
work.  See each source's note.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 112, 128)
# The kernel each dtype launches: the bf16 tensor-core kernel or the fp32
# one on the TF32 tensor cores by split products.
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 9
         + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_ARGS_TC = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def check_inputs(q, k, v, *, device="cuda"):
    """Raise ``ValueError`` for anything the kernel does not take.
    ``device="meta"`` applies the same checks to shape stand-ins (the dry
    run's route in ``ops.py``)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"the kernel needs a CUDA tensor")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v lie on different "
                             "devices")
        if t.dtype != q.dtype or t.dtype not in ROUTES:
            raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                             f"{v.dtype}; the kernel takes one of "
                             f"{sorted(map(str, ROUTES))} for all three")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"(B, S, heads, hd) with a contiguous head dim")
    B, Sq, H, hd = q.shape
    Bk, Skv, KH, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if (KH == 0 and H != 0) or (KH != 0 and H % KH):
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KH} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535 or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention: B*H = {B * H} (at most 65535) "
                         f"and Sq = {Sq}, Skv = {Skv} (non-zero)")
    if is_empty(q):
        return      # no head: nothing is loaded, whatever the strides
    if q.dtype == torch.bfloat16:
        # TMA addresses each tensor through a map: a 16-byte aligned base and
        # strides of whole 16-byte units.
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"flash_attention: bf16 {name} needs a 16-byte aligned "
                    f"base and (batch, step, head) strides that are "
                    f"multiples of 8 elements, got strides "
                    f"{tuple(t.stride())}")


def is_empty(q) -> bool:
    """Whether q holds no head: an empty head block, which has no work."""
    return q.shape[2] == 0


def flash_attention_fwd(q, k, v, *, causal=True):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KH, hd) CUDA tensors -> (B, Sq, H, hd).

    Launches on the current stream and does not synchronise; raises
    ``RuntimeError`` if the launch is refused.
    """
    check_inputs(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if ROUTES[q.dtype] == "tensor_core":
        strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                        *v.stride()[:3])
        fn = build.bind("flash_attention_tc", "flash_attention_tc_fwd",
                        _ARGS_TC)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 Sq, Skv, H, KH, hd, strides, int(causal),
                 1.0 / math.sqrt(hd), stream)
        if err < 0:
            raise RuntimeError(f"flash_attention_tc_fwd: a TMA tensor map "
                               f"could not be encoded (CUresult {-err})")
        if err != 0:
            raise RuntimeError(f"flash_attention_tc_fwd launch failed: CUDA "
                               f"error {err}")
        return o
    fn = build.bind("flash_attention", "flash_attention_fwd", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, Sq, Skv, H, KH, hd,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(causal), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return o
