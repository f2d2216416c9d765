"""Activation-sharding context: the batch axis pinned through the layer
stack (port of ``repro.models.shardctx``).

The JAX package constrains every block boundary to batch-sharded
activations so that GSPMD all-gathers the small FSDP weights instead of
the activations.  On one card there is nothing to shard: with the batch
axes set or not, :func:`constrain_batch` returns its input unchanged, as
the JAX one does with none set, and the model calls it at the same two
block boundaries.  The dry run (``launch/dryrun.py``) sets the axes of a
cell's mesh rules before it builds the step, and records them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BATCH_AXES: Optional[Tuple[str, ...]] = None


def set_batch_axes(axes) -> None:
    """axes: mesh axis name(s) carrying the batch dim, or None to disable."""
    global _BATCH_AXES
    if axes is None:
        _BATCH_AXES = None
    elif isinstance(axes, str):
        _BATCH_AXES = (axes,)
    else:
        _BATCH_AXES = tuple(axes)


def batch_axes() -> Optional[Tuple[str, ...]]:
    """The axes :func:`set_batch_axes` set (``None``: unset)."""
    return _BATCH_AXES


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """A (batch, ...) activation pinned batch-sharded: on one card, ``x``
    itself."""
    return x
