from . import (attention, blocks, common, convert, lenet, model, moe,  # noqa: F401
               ssm)
from .convert import params_from_jax  # noqa: F401
from .model import (  # noqa: F401
    forward,
    from_pipeline_params,
    init_cache,
    init_params,
    init_pipeline_params,
    init_rank_params,
    pipeline_fns,
    pipeline_param_parts,
    shard_params,
    to_pipeline_params,
)
