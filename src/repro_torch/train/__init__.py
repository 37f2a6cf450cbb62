from .loop import (  # noqa: F401
    RECOVERABLE,
    History,
    LoopConfig,
    MeshFault,
    NonFiniteStreakError,
    StragglerMonitor,
    elastic_restart_on_failure,
    restart_on_failure,
    run,
)
from .step import (  # noqa: F401
    batch_to_device,
    build_hybrid_train_step,
    build_hybrid_value_and_grad,
    build_loss_fn,
    build_pipeline_train_step,
    build_train_step,
    cross_entropy,
    hybrid_param_parts,
    init_train_state,
    loss_and_grads,
)
