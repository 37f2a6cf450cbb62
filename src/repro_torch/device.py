"""Device selection for the port's entry points.

The port computes on the card: an entry point given no device runs on
``cuda``, and raises when there is none.  It never falls back to the host
quietly; the host runs only when the caller asks for ``cpu``.
"""

from __future__ import annotations

import torch

NO_CARD = ("no CUDA device is available: pass device='cpu' (--device cpu) "
           "to run on the host")


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return dev
