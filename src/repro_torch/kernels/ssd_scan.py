"""Mamba2 SSD chunk scan forward on Hopper: ctypes wrappers of two kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_scan_fwd`` (``_ssd_kernel``).  The kernels are CUDA C++ for ``sm_90a``,
built by ``build.py`` with ``nvcc`` and bound with ``ctypes``.  Beyond the
TPU kernel they return the final state (the model's prefill keeps it for
decode) and take any sequence length (the ragged last chunk is masked).

Dispatch is by the dtype of x, B and C, a rule and not a fallback
(``ROUTES``):

- **bf16** launches ``csrc/ssd_scan_tc.cu`` on the tensor cores
  (``mma.sync``, chunks prefetched by ``cp.async``), the serving route.  W,
  the bf16 copy of the carried state and the scaled B are each split into
  bf16 hi + lo pairs, so y holds the bf16 pin (5e-2) and the final state
  the fp32 one (1e-4).  A bf16 input it does
  not take (a stride or base ``cp.async`` cannot move in 16-byte pieces)
  raises ``ValueError``.
- **fp32** launches ``csrc/ssd_scan.cu`` on the TF32 tensor cores by
  split products (``tf32x3``: each operand split into TF32 hi + lo, three
  ``mma.sync`` passes summed in fp32), which holds the fp32 pin on y and
  the final state.

A failed build or launch raises ``RuntimeError``.  An empty head block
(H = 0: a rank of a model axis larger than the SSM head count) is a
shape the wrappers take; it has no work, so ``ops`` launches nothing for
it.

Bound: at the serving shape (mamba2-370m, B=8, S=2048, H=32, P=64, N=128,
chunk 64, bf16) the scan reads x, dt, B and C once and writes y and the
final state once, ~153 MB, against ~22 GFLOP of chunk products, so it is
bound by bytes (~46 us on an H100 SXM).  The design keeps the (P, N) state
and the chunk's L x L weights out of device memory: one block per (batch,
head) walks the chunks in order with the state on chip, so device memory
sees only the inputs and outputs.  See each source's note and
PERF.md for how close each route comes to that bound.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64)        # P
MAX_STATE = 128                 # N, a multiple of 16
TILES = (16, 32, 64, 128)       # chunk tiles; every (tile, P, N) fits in
                                # shared memory, the largest in 199 KB
# The kernel each dtype of x launches: the bf16 tensor-core kernel or the
# fp32 one on the TF32 tensor cores by split products.
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "tf32x3"}
# the C interface of both kernels
_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
         + [ctypes.c_void_p, ctypes.c_void_p])
_SYMBOLS = {"tensor_core": ("ssd_scan_tc", "ssd_scan_tc_fwd"),
            "tf32x3": ("ssd_scan", "ssd_scan_fwd")}


def tile_for(chunk: int) -> int:
    """The smallest chunk tile that holds ``chunk`` steps."""
    return next((t for t in TILES if t >= chunk), 0)


def check_inputs(x, dt, a_neg, Bm, Cm, chunk, *, device="cuda"):
    """Raise ``ValueError`` for anything the kernel does not take.
    ``device="meta"`` applies the same checks to shape stand-ins (the dry
    run's route in ``ops.py``)."""
    for name, t in (("x", x), ("dt", dt), ("a_neg", a_neg), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.device.type != device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, the kernel "
                             f"needs a CUDA tensor")
        if t.device != x.device:
            raise ValueError("ssd_scan: the inputs lie on different devices")
    if (x.dtype not in ROUTES or Bm.dtype != x.dtype or Cm.dtype != x.dtype
            or dt.dtype != torch.float32 or a_neg.dtype != torch.float32):
        raise ValueError(f"ssd_scan: dtypes x {x.dtype}, Bm {Bm.dtype}, Cm "
                         f"{Cm.dtype}, dt {dt.dtype}, a_neg {a_neg.dtype}; the "
                         f"kernel takes x, Bm and Cm in one of "
                         f"{sorted(map(str, ROUTES))}, dt and a_neg in float32")
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} must be (B, S, H, P) "
                         f"and Bm {tuple(Bm.shape)} (B, S, N)")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, S, H) or tuple(a_neg.shape) != (H,)
            or tuple(Bm.shape) != (B, S, N) or tuple(Cm.shape) != (B, S, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_neg {tuple(a_neg.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if (x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1
            or not a_neg.is_contiguous()):
        raise ValueError("ssd_scan: x, Bm and Cm need a contiguous last dim "
                         "and a_neg must be contiguous")
    if P not in HEAD_DIMS or N % 16 or not 16 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: head dim {P} not in {HEAD_DIMS}, or "
                         f"state size {N} not a multiple of 16 up to "
                         f"{MAX_STATE}")
    if S == 0 or B == 0:
        raise ValueError(f"ssd_scan: S = {S} and B = {B} must be non-zero")
    L = min(chunk, S)
    if L < 1 or not tile_for(L):
        raise ValueError(f"ssd_scan: chunk {chunk} (at most {TILES[-1]})")
    if is_empty(x):
        return      # no head: nothing is loaded, whatever the strides
    if x.dtype == torch.bfloat16:
        # cp.async moves x, B and C rows in 16-byte pieces.
        for name, t, dims in (("x", x, 3), ("Bm", Bm, 2), ("Cm", Cm, 2)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:dims]):
                raise ValueError(
                    f"ssd_scan: bf16 {name} needs a 16-byte aligned base "
                    f"and leading strides that are multiples of 8 elements, "
                    f"got strides {tuple(t.stride())}")


def is_empty(x) -> bool:
    """Whether x holds no head: an empty head block, which has no work."""
    return x.shape[2] == 0


def ssd_scan_fwd(x, dt, a_neg, Bm, Cm, *, chunk=64):
    """x: (B,S,H,P); dt: (B,S,H); a_neg: (H,); Bm/Cm: (B,S,N) CUDA tensors
    -> (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) float32).

    Chunks of ``min(chunk, S)`` steps, the last one ragged.  Launches on the
    current stream and does not synchronise; raises ``RuntimeError`` if the
    launch is refused.
    """
    check_inputs(x, dt, a_neg, Bm, Cm, chunk)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 10)(*x.stride()[:3], *dt.stride(),
                                     *Bm.stride()[:2], *Cm.stride()[:2])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib, symbol = _SYMBOLS[ROUTES[x.dtype]]
    fn = build.bind(lib, symbol, _ARGS)
    err = fn(x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(), B, S, H, P, N, L,
             tile_for(L), strides, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    return y, h_final
