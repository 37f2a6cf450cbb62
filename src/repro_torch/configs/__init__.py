from .base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeCell,
    applicable_shapes,
    get_config,
    reduced,
)
