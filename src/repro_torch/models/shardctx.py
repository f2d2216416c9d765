"""Activation-sharding context: the batch axis pinned through the layer
stack (port of ``repro.models.shardctx``), and the other places a sharded
step reshards.

The JAX package constrains every block boundary to batch-sharded
activations so that GSPMD all-gathers the small FSDP weights instead of
the activations, and pins the MoE's dispatched ``(B, E, cap, d)`` buffers
to the expert axis (``moe._constrain_experts``).  On one card there is
nothing to shard: :func:`constrain_batch` and :func:`constrain_experts`
return their input unchanged, as the JAX ones do with no mesh, and the
models call them at the JAX package's places.  :func:`sync_grads` marks
where a data-parallel step would synchronise its gradients (after the
microbatches' accumulation, before the optimizer); it too returns its
input.

The dry run (``launch/dryrun.py``) sets the axes of a cell's mesh rules
before it builds the step, and records them.  Its counter
(``launch/counting.py``) installs itself with :func:`observe` and reads
each hook's tensors as the collective that point implies under the
cell's meshes; with no observer installed (every run on the card) a hook
is one ``is None`` test.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch

_BATCH_AXES: Optional[Tuple[str, ...]] = None
_OBSERVER = None


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


@contextlib.contextmanager
def observe(observer):
    """Hand every hook's tensors to ``observer`` (``reshard(point, x)``,
    ``sync_grads(params, grads)``) while the context is open."""
    global _OBSERVER
    prev, _OBSERVER = _OBSERVER, observer
    try:
        yield observer
    finally:
        _OBSERVER = prev


class _Reshard(torch.autograd.Function):
    """The identity, reported to the observer in the forward and, for its
    gradient, in the backward (a resharding's transpose moves the
    cotangent back)."""

    @staticmethod
    def forward(ctx, point: str, x: torch.Tensor) -> torch.Tensor:
        ctx.point = point
        _OBSERVER.reshard(point, x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if _OBSERVER is not None:
            _OBSERVER.reshard(ctx.point, grad)
        return None, grad


def _reshard(point: str, x: torch.Tensor) -> torch.Tensor:
    if _OBSERVER is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reshard.apply(point, x)
    _OBSERVER.reshard(point, x)
    return x


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """A (batch, ...) activation pinned batch-sharded: on one card, ``x``
    itself."""
    return _reshard("batch", x)


def constrain_experts(x: torch.Tensor) -> torch.Tensor:
    """A ``(B, E, cap, d)`` MoE buffer pinned to the expert axis: on one
    card, ``x`` itself."""
    return _reshard("experts", x)


def sync_grads(params: Sequence[torch.Tensor],
               grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The step's gradients, ``grads[i]`` of ``params[i]``, where a
    data-parallel step synchronises them: on one card, ``grads``."""
    if _OBSERVER is not None:
        _OBSERVER.sync_grads(params, grads)
    return grads
