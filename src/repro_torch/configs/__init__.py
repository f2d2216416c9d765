from .base import (
    ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, cell_is_skipped, get_config,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "cell_is_skipped",
    "get_config",
]
