"""Flash attention forward on Hopper: ctypes wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_fwd`` (``_flash_kernel``).  The kernel is CUDA C++ for
``sm_90a``, built by ``build.py`` with ``nvcc`` and bound with ``ctypes``.

Bound: causal prefill at the serving shape (glm4-9b, B=4, S=1024, bf16)
does 34.4 GFLOP on ~71 MB, so it is bound by operations (tensor-core time
~35 us against ~21 us of memory on an H100 SXM).  The design keeps the
S x S scores out of device memory (online softmax over KV tiles in
registers), reads each KV head once per q tile without materialising the
GQA repeat, and skips the tiles above the causal diagonal, halving the
work.  This first version multiplies on the fp32 CUDA cores, not the
tensor cores; see the source's note.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = ctypes.CDLL(str(build.build()["flash_attention"]))
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check_inputs(q, k, v):
    """Raise ``ValueError`` for anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"the kernel needs a CUDA tensor")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k and v lie on different "
                             "devices")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                             f"{v.dtype}; the kernel takes one of "
                             f"{sorted(map(str, DTYPES))} for all three")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"(B, S, heads, hd) with a contiguous head dim")
    B, Sq, H, hd = q.shape
    Bk, Skv, KH, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if KH == 0 or H % KH:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KH} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535 or Sq == 0 or Skv == 0:
        raise ValueError(f"flash_attention: B*H = {B * H} (at most 65535) "
                         f"and Sq = {Sq}, Skv = {Skv} (non-zero)")


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
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    DTYPES[q.dtype], B, Sq, Skv, H, KH, hd,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    int(causal), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return o
