from . import attention, blocks, common, convert, model  # noqa: F401
from .convert import params_from_jax  # noqa: F401
from .model import forward, init_cache, init_params  # noqa: F401
