from .base import (
    ARCH_IDS, SHAPES, ArchConfig, ShapeConfig, cell_is_skipped, get_config,
    logical_to_spec, mesh_rules,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ArchConfig", "ShapeConfig", "cell_is_skipped",
    "get_config", "logical_to_spec", "mesh_rules",
]
