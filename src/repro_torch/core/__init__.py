"""Core of the port: the paper's linear-algebraic model parallelism over
``torch.distributed`` (mirrors ``repro/core``; the modules ported so far).

- ``memory``      linear memory ops + adjoints            (paper §2, App. A)
- ``partition``   balanced decomposition + halo geometry  (paper §3, App. B)
- ``primitives``  parallel data movement + manual adjoints (paper §3)
- ``linop``       the operator algebra: composable adjoint-aware LinearOps
- ``adjoint``     the Eq. 13 coherence test harness
- ``ring_attention``  context parallelism: the KVRingShift ring (DESIGN §6)
"""

from . import (  # noqa: F401
    adjoint,
    linop,
    memory,
    partition,
    primitives,
    ring_attention,
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
from .ring_attention import (  # noqa: F401
    attention_working_set_bytes,
    check_attention_budget,
    ring_attention_region,
    ring_hop,
)
