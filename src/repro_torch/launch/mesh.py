"""Meshes (port of ``repro.launch.mesh``).

The reference's production meshes are TPU pods: 16 x 16 = 256 chips,
axes ("data", "model"), and 2 pods x 256 = 512 chips, axes ("pod",
"data", "model"), the "pod" axis carrying only data parallelism.  The
port prices a cell per card under those meshes' sharding rules
(``launch/dryrun.py``) without making a device, so
:func:`make_production_mesh` returns the mesh's shape and axis names as a
:class:`MeshShape`.  :func:`make_local_mesh` is a real mesh over the
visible cards: the port's ``core.array_sim.Mesh``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple


class MeshShape(NamedTuple):
    """A mesh as a description: its shape and axis names, no devices."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_local_mesh(model: int = 1, data: Optional[int] = None):
    """A ("data", "model") mesh over the visible cards (tests: pass
    ``data`` and ``model`` whose product is the card count)."""
    import numpy as np
    import torch

    from ..core.array_sim.mesh import Mesh

    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_local_mesh: no CUDA device is visible")
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"make_local_mesh: {data} x {model} is not the "
                         f"{n} visible cards")
    devices = np.array([f"cuda:{i}" for i in range(n)],
                       dtype=object).reshape(data, model)
    return Mesh(devices, ("data", "model"))


def mesh_chip_count(mesh) -> int:
    """Chips in a mesh: a :class:`MeshShape` or a mesh with ``devices``."""
    if hasattr(mesh, "devices"):
        return math.prod(mesh.devices.shape)
    return math.prod(mesh.shape)
