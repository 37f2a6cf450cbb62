"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

The layout mirrors ``src/repro`` file for file.  This package imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and
nothing of ``repro``.  Entry points run on ``cuda`` unless the caller asks
for ``cpu`` (see :func:`repro_torch.device.resolve_device`).
"""
