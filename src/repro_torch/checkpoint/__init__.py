from . import ckpt  # noqa: F401
from .ckpt import (  # noqa: F401
    CorruptCheckpointError,
    LeafReshardPlan,
    MeshMismatchError,
    capture_layouts,
    check_pending,
    latest_step,
    plan_reshard,
    quarantine,
    restore,
    restore_latest_verified,
    restore_resharded,
    save,
    save_async,
    settle,
    wait_pending,
)
