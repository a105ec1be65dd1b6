"""Meshes of the port (``repro.launch.mesh``).

Two kinds of mesh, which the sharding rules, the dispatcher and the dry
run read alike through :func:`axis_sizes`:

* a **live mesh** is a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names`` ``("data", "model")`` (or ``("pod", "data",
  "model")``), one process a rank, built over a process group
  (:func:`make_host_mesh`); its collectives run on
  ``mesh.get_group(name)`` (:func:`axis_group`);
* a **device-free mesh** (:class:`AbstractMesh`) has the reference's
  ``.shape`` (axis -> size, in order), ``.axis_names`` and ``.size`` and
  nothing else: the production meshes of the dry run, and the one-device
  mesh of a process started without ranks.

Everything is built by a function, never at import, so importing this
module touches no process group and no device. Single pod:
(data=16, model=16) = 256 cards; multi-pod: (pod=2, data=16, model=16) =
512; the 'pod' axis joins 'data' for batch / FSDP sharding.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A device-free mesh: axis names and sizes, no ranks."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A device-free mesh of ``shape`` over ``axes``."""
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh's geometry, (16, 16) or (2, 16, 16). The port
    returns it device-free: a live mesh of 256 or 512 ranks is what
    :func:`make_host_mesh` builds under a launcher that starts them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_abstract_mesh(shape, axes)


def _local_rank() -> int:
    import torch.distributed as dist
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str | None = None) -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` when the
    process has a card (or ``device_type`` is 'cuda'), else the CPU."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return torch.device(device_type)


def init_ranks() -> bool:
    """Join the process group that ``RANK`` / ``WORLD_SIZE`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets them) describe,
    unless one is initialized already. True when the process is in a group
    of more than one rank. The backend is NCCL when every rank of the host
    has a card of its own, else gloo."""
    import torch.distributed as dist
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1 or "RANK" not in os.environ:
            return False
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= local_world else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size() > 1


def make_host_mesh(model_parallel: int = 1):
    """(world // model_parallel, model_parallel) over ("data", "model").

    Over the initialized process group, or over one started from
    ``RANK`` / ``WORLD_SIZE`` (:func:`init_ranks`); with neither, the
    one-device mesh (1, 1), which needs no process group, as the
    reference's mesh on one device."""
    import torch.distributed as dist
    if not init_ranks():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs "
                             f"{model_parallel} ranks; this process runs "
                             "alone (start it under torchrun)")
        return make_abstract_mesh((1, 1), ("data", "model"))
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"world {world} is not a multiple of "
                         f"model_parallel={model_parallel}")
    return make_live_mesh((world // model_parallel, model_parallel),
                          ("data", "model"))


def make_live_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the initialized
    process group (every rank calls it). Its device type is 'cuda' under
    NCCL and 'cpu' under gloo, whose ranks may share one card: the type
    only matters to DTensor, and the model path moves no DTensor; each
    rank's tensors live on :func:`rank_device`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.get_backend() == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
        return init_device_mesh("cuda", tuple(shape),
                                mesh_dim_names=tuple(axes))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


# ---------------------------------------------------------------------------
# Reading either kind of mesh.
# ---------------------------------------------------------------------------

def is_live(mesh) -> bool:
    """Does ``mesh`` have ranks (and process groups)?"""
    return mesh is not None and hasattr(mesh, "get_group")


def axis_sizes(mesh) -> dict:
    """{axis: size} in the mesh's order; {} for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # a DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {str(a): int(s) for a, s in dict(mesh.shape).items()}


def _as_axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes) -> int:
    """This rank's coordinate along ``axes`` (one axis name or a tuple,
    row-major as the reference's PartitionSpec orders a tuple); 0 on a
    device-free mesh."""
    sizes = axis_sizes(mesh)
    idx = 0
    for ax in _as_axes(axes):
        local = mesh.get_local_rank(ax) if is_live(mesh) else 0
        idx = idx * sizes[ax] + local
    return idx


_FLAT_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group of ``axes`` (one axis name or a tuple) that holds
    this rank. A tuple of several axes is flattened once (every rank must
    reach the first call together, as SPMD code does)."""
    axes = _as_axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _FLAT_GROUPS:
        _FLAT_GROUPS[key] = mesh[axes]._flatten().get_group()
    return _FLAT_GROUPS[key]


@dataclasses.dataclass(frozen=True)
class RowsLocal:
    """A mesh whose data axes read as size 1: the view a training step
    partitions its dense calls over. Each data rank already holds its own
    rows of the batch, so only 'model' splits a product."""
    mesh: object

    @property
    def shape(self) -> dict:
        return {a: (1 if a in DATA_AXES else s)
                for a, s in axis_sizes(self.mesh).items()}

    @property
    def axis_names(self) -> tuple:
        return tuple(axis_sizes(self.mesh))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def get_group(self, name):
        return self.mesh.get_group(name)

    def get_local_rank(self, name) -> int:
        return 0 if name in DATA_AXES else self.mesh.get_local_rank(name)
