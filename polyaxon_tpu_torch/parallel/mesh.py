"""Mesh construction and sharding helpers.

Port of ``polyaxon_tpu/parallel/mesh.py``.  Canonical axis names, in the
reference's order:

    dp   data parallel (gradient all-reduce)
    fsdp fully-sharded data parallel (param shard + all-gather)
    tp   tensor parallel
    pp   pipeline parallel
    sp   sequence/context parallel
    ep   expert parallel (MoE all-to-all)

The reference's mesh is a ``jax.sharding.Mesh`` of devices; here a mesh
is a :class:`Mesh`: one rank per process of the gang, the six axes laid
over the ranks in row-major order (``dp`` outermost), and, when a
process group is up, the ``torch.distributed.device_mesh.DeviceMesh``
over the world with the same six named dimensions (size-1 axes kept so
every name resolves), whose ``get_group(axis)`` the collectives use.
With no group the mesh is this process's one device.  On multi-slice
hardware ``dp`` spans the slices: slice ``s`` holds the ``s``-th block of
consecutive ranks.

A batch is sharded over the data axes (``dp`` x ``fsdp``) by rows:
:func:`data_sharding` names the rows of the global batch this rank
holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "ep", "tp")


class MeshError(ValueError):
    pass


@dataclass
class MeshSpec:
    """Declarative mesh: axis name -> size; -1 for 'fill with the rest'."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    num_slices: int = 1

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, int]]) -> "MeshSpec":
        data = dict(data or {})
        known = {k: int(v) for k, v in data.items()
                 if k in AXIS_ORDER or k == "num_slices"}
        unknown = set(data) - set(known)
        if unknown:
            raise MeshError(f"Unknown mesh axes: {sorted(unknown)}")
        return cls(**known)

    def sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill -1 axes so the product equals n_devices."""
        sizes = self.sizes()
        fill_axes = [a for a, s in sizes.items() if s == -1]
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if n_devices % fixed:
            raise MeshError(
                f"Mesh axes {sizes} do not divide device count {n_devices}"
            )
        remaining = n_devices // fixed
        if not fill_axes:
            if fixed != n_devices:
                raise MeshError(
                    f"Mesh axes product {fixed} != device count {n_devices}"
                )
        elif len(fill_axes) == 1:
            sizes[fill_axes[0]] = remaining
        else:
            sizes[fill_axes[0]] = remaining
            for a in fill_axes[1:]:
                sizes[a] = 1
        return sizes


def mesh_layout(spec: MeshSpec, n_devices: int
                ) -> Tuple[Dict[str, int], np.ndarray]:
    """(axis sizes, ranks laid over the axes in ``AXIS_ORDER``) for
    ``n_devices`` ranks.  With ``num_slices > 1`` the dp axis spans the
    slices and must divide by their number (the reference's hybrid ICI x
    DCN check); each slice is a block of consecutive ranks."""
    sizes = spec.resolve(n_devices)
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    if spec.num_slices > 1 and shape[0] % spec.num_slices:
        raise MeshError(
            f"dp axis ({shape[0]}) must be divisible by num_slices "
            f"({spec.num_slices}) for hybrid ICI x DCN meshes"
        )
    return sizes, np.arange(n_devices).reshape(shape)


class Mesh:
    """The port's ``jax.sharding.Mesh``: ``shape`` (axis -> size, in
    ``AXIS_ORDER``), ``axis_names``, ``devices`` (the ranks, shaped by
    the axes), this process's ``rank`` and ``device``, the ``spec`` it
    was built from, and ``device_mesh``: the ``DeviceMesh`` over the
    world when a process group is up (:attr:`is_distributed`), else
    None."""

    def __init__(self, sizes: Dict[str, int], ranks: np.ndarray,
                 device: torch.device, device_mesh=None, rank: int = 0,
                 spec: Optional[MeshSpec] = None):
        self.shape = {a: int(sizes[a]) for a in AXIS_ORDER}
        self.axis_names = AXIS_ORDER
        self.devices = ranks
        self.device = device
        self.device_mesh = device_mesh
        self.rank = rank
        self.spec = spec or MeshSpec()

    @property
    def is_distributed(self) -> bool:
        return self.device_mesh is not None

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[AXIS_ORDER.index(axis)])

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (None with no
        process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self.device}, "
                f"distributed={self.is_distributed})")


def build_mesh(spec: Optional[MeshSpec] = None,
               devices: Optional[Sequence] = None, *,
               device: Union[str, torch.device, None] = None) -> Mesh:
    """A :class:`Mesh` from a spec.

    With a process group up it spans the world: one rank per process,
    on the device the bootstrap gave this process, over a ``DeviceMesh``
    of the six named axes.  With none it is this process's one device
    (``device``, else the first of ``devices``, else ``cuda``): a spec
    that resolves to more than one device raises the reference's
    :class:`MeshError` (``Mesh axes product 2 != device count 1``);
    ``devices`` of more than one raises too, as one process drives one
    device."""
    from . import bootstrap

    spec = spec or MeshSpec()
    if bootstrap.is_initialized():
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        world, rank = dist.get_world_size(), dist.get_rank()
        sizes, ranks = mesh_layout(spec, world)
        dev = bootstrap.current_device() or torch.device(
            device if device is not None else "cpu")
        dm = init_device_mesh(dev.type, tuple(sizes[a] for a in AXIS_ORDER),
                              mesh_dim_names=AXIS_ORDER)
        return Mesh(sizes, ranks, dev, dm, rank, spec)
    devices = list(devices) if devices is not None else None
    sizes, ranks = mesh_layout(spec, len(devices) if devices else 1)
    if devices and len(devices) > 1:
        raise MeshError(
            f"a mesh of {len(devices)} devices needs one process per "
            f"device: start a gang with the PTPU_* block")
    if device is None:
        device = devices[0] if devices else "cuda"
    return Mesh(sizes, ranks, torch.device(device), None, 0, spec)


def local_mesh(**axis_sizes: int) -> Mesh:
    """Convenience: mesh over the gang (or this device), e.g.
    local_mesh(dp=2, fsdp=2)."""
    return build_mesh(MeshSpec.from_dict(axis_sizes))


def active_batch_axes(mesh, batch_axes: Tuple[str, ...] = ("dp", "fsdp")):
    """The subset of ``batch_axes`` with size > 1 on this mesh (or None).

    Single source of truth for "which axes shard the batch dim" — used by
    data_sharding, the strategy library and the losses' global sums."""
    return tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1) or None


@dataclass(frozen=True)
class DataSharding:
    """Rows of a [batch, ...] array one rank holds: block ``index`` of
    ``count`` equal blocks, on ``device``."""

    device: torch.device
    index: int = 0
    count: int = 1

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(
                f"global batch {n} does not divide over the data axes "
                f"({self.count}): the batch size must be a multiple of "
                f"dp x fsdp")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def shard(self, array):
        """This rank's rows of ``array`` (a numpy array or tensor)."""
        return array[self.rows(len(array))]


def data_sharding(mesh, *, batch_axes: Tuple[str, ...] = ("dp", "fsdp")
                  ) -> DataSharding:
    """The rows of a [batch, ...] array sharded over the data axes that
    this rank holds: its block, counted over the active batch axes in
    order (dp major, fsdp minor, the reference's ``P(("dp", "fsdp"))``)."""
    index, count = 0, 1
    for axis in active_batch_axes(mesh, batch_axes) or ():
        index = index * mesh.shape[axis] + mesh.coordinate(axis)
        count *= mesh.shape[axis]
    return DataSharding(mesh.device, index, count)


def replicate_sharding(mesh) -> DataSharding:
    """Every row on every rank."""
    return DataSharding(mesh.device, 0, 1)


def logical_axis_rules(spec: Optional[MeshSpec] = None) -> List[Tuple[str, Optional[str]]]:
    """flax-style logical->mesh axis rules for the standard vocabulary."""
    return [
        ("batch", ("dp", "fsdp")),
        ("seq", "sp"),
        ("embed", "fsdp"),
        ("hidden", "tp"),
        ("heads", "tp"),
        ("kv", None),
        ("mlp", "tp"),
        ("vocab", "tp"),
        ("expert", "ep"),
        ("stage", "pp"),
    ]
