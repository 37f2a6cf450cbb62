"""Core of the port: the paper's linear-algebraic model parallelism over
``torch.distributed`` (mirrors ``repro/core``; the modules ported so far).

- ``memory``      linear memory ops + adjoints            (paper §2, App. A)
- ``partition``   balanced decomposition + halo geometry  (paper §3, App. B)
- ``primitives``  parallel data movement + manual adjoints (paper §3)
- ``linop``       the operator algebra: composable adjoint-aware LinearOps
- ``adjoint``     the Eq. 13 coherence test harness
"""

from . import (  # noqa: F401
    adjoint,
    linop,
    memory,
    partition,
    primitives,
)

from .adjoint import adjoint_test, inner, norm  # noqa: F401
from .linop import check_adjoint  # noqa: F401
from .partition import (  # noqa: F401
    TensorPartition,
    balanced_split,
    compute_halos,
    conv_output_size,
    is_sensible_decomposition,
    max_halo_widths,
)
