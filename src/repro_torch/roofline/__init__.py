"""Roofline bounds of the port's own programs (mirrors ``repro/roofline``).

- ``analysis``: the H100 peaks and the three-term roofline over a trace
  (each kernel call's cost is ``kernels/cost.py``'s).
- ``hlo_profile``: the trace itself (``OpRecord``s of aten ops, kernel
  calls and collectives) and the structural reports over it.
- ``report``: the tables of the dry run's results.
"""
