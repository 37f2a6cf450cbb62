from .optimizers import (  # noqa: F401
    Adafactor,
    AdamW,
    clip_by_global_norm,
    compress_grads,
    global_norm,
    make_optimizer,
    warmup_cosine,
)
