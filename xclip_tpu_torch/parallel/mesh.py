"""The device mesh — the counterpart of `xclip_tpu/parallel/mesh.py`.

A JAX `Mesh` names the axes of a grid of devices; here the grid holds
`torch.distributed` ranks, one rank a device, and each axis of it is a set
of process groups: along 'data', the ranks that share this rank's index on
every other axis (its data group, over which the batch is sharded and the
gradients are summed), and along 'model' likewise (its model group, over
which the tensor-parallel parameters are sharded). Ranks fill the grid in
row-major order, as `np.asarray(devices).reshape(axis_sizes)` fills JAX's.

`data_sharding` and `replicated` are the placements `train.shard_batch`
and `parallel.shard_params` read: a `NamedSharding` of the mesh and a
`PartitionSpec`, as JAX's, naming the mesh axis each dimension is split
over (None: whole). Splitting a dimension over an axis gives the rank at
index i of that axis its i-th contiguous block; a `NamedSharding` with
`parts` > 1 splits each of that many equal pieces of the dimension so (the
port's layout of the fused qkv and GEGLU weights, `parallel.sharding`).

`create_mesh` is collective: every rank of the default process group
calls it, in the same order, since each process group is made by all of
them (`torch.distributed.new_group`), members or not. A rank outside
`devices` holds a mesh whose `member` is False and whose groups it cannot
use.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: for each dimension, the mesh axis it
    is split over, or None; missing trailing dimensions are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A grid of ranks with named axes (`jax.sharding.Mesh`): `devices` the
    grid of global ranks, `axis_names`, `shape` (axis → size, an
    `OrderedDict` as JAX's), and for this rank, when a `member`, its index
    along each axis (`index`) and the process group along it (`group`)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 devices.shape))
        rank = dist.get_rank()
        where = np.argwhere(devices == rank)
        self.member = len(where) == 1
        self._coords = dict(zip(self.axis_names, where[0].tolist())) \
            if self.member else {}
        self._groups = {}
        world = list(range(dist.get_world_size()))
        for a, name in enumerate(self.axis_names):
            # every line of ranks along axis a, in one order on every rank
            lines = np.moveaxis(devices, a, -1).reshape(-1, devices.shape[a])
            for line in lines.tolist():
                group = (dist.group.WORLD if line == world
                         else dist.new_group(line))
                if rank in line:
                    self._groups[name] = group

    def group(self, axis: str):
        """This rank's process group along `axis`."""
        self._check(axis)
        return self._groups[axis]

    def index(self, axis: str) -> int:
        """This rank's index along `axis`."""
        self._check(axis)
        return self._coords[axis]

    def axis_size(self, axis: str) -> int:
        """The size of `axis` (1 for an axis the mesh does not have)."""
        return int(self.shape.get(axis, 1))

    def _check(self, axis):
        if not self.member:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh "
                             f"(ranks {self.devices.ravel().tolist()})")
        if axis not in self.shape:
            raise ValueError(f"the mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")

    def __repr__(self):
        return (f"Mesh({self.devices.tolist()}, "
                f"axis_names={self.axis_names})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """`jax.sharding.NamedSharding`: a mesh and a `PartitionSpec`, and the
    port's `parts` (see the module docstring)."""
    mesh: Mesh
    spec: PartitionSpec
    parts: int = 1

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None or self.mesh.axis_size(a) == 1
                   for a in self.spec)


def create_mesh(axis_sizes: Optional[Sequence[int]] = None,
                axis_names: Tuple[str, ...] = ("data", "model"),
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over `devices` (global ranks; default every rank of the
    default process group, which must be initialised).

    Default layout: all ranks on the 'data' axis, 'model' of size 1 (pure
    data parallelism). Pass e.g. `axis_sizes=(4, 2)` for 4-way data × 2-way
    tensor parallelism. A grid that does not cover `devices` raises JAX's
    AssertionError. Collective (see the module docstring)."""
    if not dist.is_initialized():
        raise ValueError("create_mesh needs the default process group: "
                         "call torch.distributed.init_process_group first")
    devices = list(range(dist.get_world_size())) if devices is None \
        else [int(d) for d in devices]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise AssertionError(f"mesh {tuple(axis_sizes)} does not cover {n} "
                             "devices")
    return Mesh(np.asarray(devices).reshape(tuple(axis_sizes)), axis_names)


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """Shard array dimension `axis` (the batch dim) over the 'data' mesh
    axis."""
    spec = [None] * ndim
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    """Whole on every rank of the mesh."""
    return NamedSharding(mesh, P())
