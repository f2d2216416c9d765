"""Device meshes of the batched simulator's runner (``make_runner(mesh=)``).

The JAX package hands ``make_runner`` a ``jax.sharding.Mesh`` and runs the
batched step as a ``shard_map`` over it: every device runs its own lane
shard at the same time, and the devices of a page row each scan their own
slice of the pool.  The port takes two kinds of mesh, read by the JAX
package's rules (the first axis splits the lanes evenly, the second, if
any, is the page axis; any other number of axes is refused):

* a ``torch.distributed`` ``DeviceMesh`` (``mesh_dim_names`` ``('lanes',)``
  or ``('lanes', 'page')``; :func:`~repro_torch.core.array_sim.dist.init_mesh`
  makes one): one process a device, every process running the same
  program.  Each rank runs the lane shard of its ``lanes`` coordinate on
  its own device while the others run theirs, the ranks of a page row
  split the eviction and grant selections across themselves (an
  all-gather inside the step), and every rank gets the whole state back;
* the one-process :class:`Mesh`, a numpy array of devices and one name
  per axis, for ONE device: one runner takes all the lanes there (lane
  shards on one device would only run in turn, to the same bits), and the n
  page shards of a row run as blocks of that card (``kernels.ops``
  ``page_shards=n``).  A :class:`Mesh` that names two devices is refused:
  running their shards in turn from one process would leave every card
  but one idle, where the JAX runner runs them at once.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "MeshRanks", "check_axes", "is_device_mesh",
           "lane_devices", "mesh_ranks", "page_shards_of"]


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


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``torch.distributed`` ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def _axis_names(mesh) -> tuple:
    if is_device_mesh(mesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("make_runner(mesh=...): name the DeviceMesh's "
                             "dimensions ('lanes',) or ('lanes', 'page')")
        return tuple(mesh.mesh_dim_names)
    return mesh.axis_names


def check_axes(mesh) -> None:
    """The JAX package's refusals: a mesh that is neither a :class:`Mesh`
    nor a ``DeviceMesh`` (``TypeError``), or that has neither one nor two
    axes (``ValueError``, the JAX message)."""
    if not (isinstance(mesh, Mesh) or is_device_mesh(mesh)):
        raise TypeError(
            f"make_runner(mesh=...) takes a repro_torch.core.array_sim.Mesh "
            f"or a torch.distributed DeviceMesh, got {type(mesh).__name__}")
    names = _axis_names(mesh)
    if len(names) not in (1, 2):
        raise ValueError(
            f"make_runner(mesh=...) wants a one-axis lane mesh or a "
            f"two-axis ('lane', 'page') mesh, got axes {names}")


def lane_devices(mesh: Mesh) -> list:
    """The device of each lane shard of a one-process :class:`Mesh`: the
    mesh's devices (one axis) or each page row's (two axes), all of them
    one device."""
    check_axes(mesh)
    named = list(dict.fromkeys(mesh.devices.reshape(-1)))
    if len(named) > 1:
        raise NotImplementedError(
            f"make_runner(mesh=...): the mesh {mesh.shape} names the devices "
            f"{named}, and one process runs one device; over several "
            "devices pass a torch.distributed DeviceMesh, one process a "
            "device (repro_torch.core.array_sim.init_mesh, or torchrun)")
    if len(mesh.axis_names) == 1:
        return list(mesh.devices)
    return [row[0] for row in mesh.devices]


def page_shards_of(mesh: Mesh) -> int:
    """Page shards of the mesh: the size of its second axis, else 1."""
    check_axes(mesh)
    return int(mesh.devices.shape[1]) if len(mesh.axis_names) == 2 else 1


class MeshRanks(NamedTuple):
    """This process's place in a ``DeviceMesh``."""

    lane_shard: int          # its coordinate on the lanes axis
    lane_shards: int         # the lanes axis' size
    lanes_group: object      # the process group of its lanes axis
    page_group: object       # of its page row (None: one-axis mesh)
    page_axis: object        # the page axis' name (None: one-axis mesh)
    device: torch.device     # the device it runs on


def mesh_ranks(mesh) -> MeshRanks:
    """Read a ``DeviceMesh`` for this process.  Its device is the current
    CUDA device (``init_mesh`` sets it, one card a rank) for a ``cuda``
    mesh, the CPU for a ``cpu`` one."""
    check_axes(mesh)
    names = _axis_names(mesh)
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    elif mesh.device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"make_runner(mesh=...): a DeviceMesh of "
                         f"{mesh.device_type!r} devices; cuda or cpu")
    two = len(names) == 2
    return MeshRanks(
        lane_shard=mesh.get_local_rank(0), lane_shards=mesh.size(0),
        lanes_group=mesh.get_group(0),
        page_group=mesh.get_group(1) if two else None,
        page_axis=names[1] if two else None, device=device)
