"""Device meshes of the batched simulator's runner (``make_runner(mesh=)``).

The JAX package hands ``make_runner`` a ``jax.sharding.Mesh`` and runs the
batched step as a ``shard_map`` over it.  The port's :class:`Mesh` has the
same two parts, a numpy array of devices and one name per axis, and
``make_runner`` reads it by the JAX package's rules:

* one axis: the lanes split evenly over the listed devices, each shard runs
  on its own device, and the results are gathered on the first one;
* two axes ``('lanes', 'page')`` of shape ``(k, n)``: the lanes split over
  the k rows, and the n page shards of a row run as blocks of ONE card
  (``kernels.ops`` ``page_shards=n``): every device of a row must be the
  same device;
* any other number of axes is refused.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["Mesh", "check_axes", "lane_devices", "page_shards_of"]


class Mesh:
    """``devices``: an array-like of devices (``torch.device`` or what it
    takes, ``"cuda:0"``, ``"cpu"``) shaped like the mesh; ``axis_names``:
    one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"Mesh: {len(self.axis_names)} axis names "
                f"{self.axis_names} for a device array of shape "
                f"{self.devices.shape}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices.tolist()})"


def check_axes(mesh) -> None:
    """The JAX package's refusals: a mesh that is not a :class:`Mesh`
    (``TypeError``), or that has neither one nor two axes
    (``ValueError``, the JAX message)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"make_runner(mesh=...) takes a repro_torch.core.array_sim.Mesh, "
            f"got {type(mesh).__name__}")
    if len(mesh.axis_names) not in (1, 2):
        raise ValueError(
            f"make_runner(mesh=...) wants a one-axis lane mesh or a "
            f"two-axis ('lane', 'page') mesh, got axes {mesh.axis_names}")


def lane_devices(mesh: Mesh) -> list:
    """The device of each lane shard: the mesh's devices (one axis), or
    the device of each row of the page axis (two axes), which must be one
    card a row."""
    check_axes(mesh)
    if len(mesh.axis_names) == 1:
        return list(mesh.devices)
    out = []
    for row in mesh.devices:
        if any(d != row[0] for d in row):
            raise NotImplementedError(
                f"make_runner(mesh=...): the page axis "
                f"{mesh.axis_names[1]!r} spans the devices {list(row)}; the "
                "port runs a row's page shards as blocks of one card, and a "
                "page axis across cards is not ported yet (ROADMAP A.11)")
        out.append(row[0])
    return out


def page_shards_of(mesh: Mesh) -> int:
    """Page shards of the mesh: the size of its second axis, else 1."""
    check_axes(mesh)
    return int(mesh.devices.shape[1]) if len(mesh.axis_names) == 2 else 1
