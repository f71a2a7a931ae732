"""Device meshes over the ranks of a ``torch.distributed`` job (the port of
``ddstore_tpu/parallel/mesh.py:26-57``).

Every multi-process path of the port runs one rank per device, so a mesh
is a :class:`~torch.distributed.device_mesh.DeviceMesh` over the whole
initialised world: rank ``r`` sits at the position of device ``r`` in the
reference's ``devices.reshape(sizes)``. The axes keep the reference's
names and order (``AXIS_ORDER``, outer to inner), and each axis carries
its own process group (``mesh.get_group("sp")``), made when the mesh is.

* ``dp`` — data parallel (the batch dimension),
* ``tp`` — tensor parallel (model dims),
* ``sp`` — sequence/context parallel (ring attention),
* ``pp`` — pipeline stages,
* ``ep`` — expert parallel (MoE routing).

The reference's ``local_mesh``, ``batch_sharding``, ``replicate`` and
``shard_batch`` (``mesh.py:59-84``) place whole arrays with GSPMD; here
they are DTensor placements: :class:`Placement` is a mesh and one
placement a mesh dim, and :func:`shard_batch` wraps this rank's rows as
its shard of the global batch. :func:`axes_group` is the process group
of the ranks that differ only along some axes (the data ranks of a step,
``dp`` x ``sp`` x ``fsdp``), and :func:`stage_ring` a rank's pipeline
ring: the group of the ranks that differ from it only along ``pp``, with
a timeout of its own, and its neighbours on that axis.
"""

from __future__ import annotations

import datetime
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["AXIS_ORDER", "make_mesh", "data_parallel_mesh", "axis_size",
           "axis_index", "axes_group", "stage_ring", "StageRing", "local_mesh", "Placement",
           "batch_sharding", "replicate", "shard_batch"]

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")  # outer -> inner


def make_mesh(axes: Dict[str, int], device_type: Optional[str] = None):
    """A ``DeviceMesh`` with the given axis sizes, e.g. ``{"dp": 2, "sp":
    4}``, over every rank of the initialised world. Axes follow
    ``AXIS_ORDER``; axes it does not know come after, sorted. The product
    of the sizes must be the world size. A collective: every rank calls
    it, with the same axes.

    ``device_type`` defaults to ``"cuda"`` where there is a card, else
    ``"cpu"`` (gloo worlds on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised "
                           "torch.distributed job (one rank per device)")
    names = [a for a in AXIS_ORDER if a in axes]
    names += sorted(set(axes) - set(names))
    sizes = [int(axes[a]) for a in names]
    n = 1
    for s in sizes:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh wants {n} devices, have {world}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def data_parallel_mesh(n: Optional[int] = None,
                       device_type: Optional[str] = None):
    """1-D ``dp`` mesh over the world (``n``, when given, must be the
    world size)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh({"dp": world if n is None else n}, device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` in ``mesh``; 1 when the mesh has no such axis
    (or there is no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis`` (0 without the axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


def axes_group(mesh, axes: Sequence[str]):
    """The process group of this rank and the ranks that differ from it
    only along ``axes`` (axes the mesh lacks, or of size 1, are left out);
    None when that is this rank alone. A collective the first time a mesh
    is asked for a set of axes (every rank makes every such group, in the
    same order); cached on the mesh after."""
    axes = tuple(a for a in (mesh.mesh_dim_names or ())
                 if a in axes and axis_size(mesh, a) > 1) \
        if mesh is not None else ()
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_ddstore_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        ranks = mesh.mesh.permute(*rest, *keep).reshape(
            -1, int(torch.tensor([mesh.mesh.shape[i] for i in keep]).prod()))
        me = dist.get_rank()
        for row in ranks.tolist():
            g = dist.new_group(row)
            if me in row:
                cache[axes] = g
    return cache[axes]


class StageRing(NamedTuple):
    """A rank's place on the pipeline axis: the process group of the ranks
    that differ from it only along that axis (None at size 1), its index
    and the axis size, and the global ranks of the stages before and
    after it (mod ``size``)."""

    group: object
    index: int
    size: int
    prev: int
    next: int


#: seconds a stage hand-off waits for its peer before it raises (a
#: mismatched schedule fails instead of hanging the job)
STAGE_TIMEOUT_S = 600.0


def stage_ring(mesh, axis: str = "pp") -> StageRing:
    """This rank's :class:`StageRing` along ``axis``. The group is made
    with ``STAGE_TIMEOUT_S``: a collective the first time a mesh is asked
    for it (every rank makes every row's group, in the same order);
    cached on the mesh after."""
    n = axis_size(mesh, axis)
    if n == 1:
        me = dist.get_rank() if dist.is_initialized() else 0
        return StageRing(None, 0, 1, me, me)
    cache = mesh.__dict__.setdefault("_ddstore_groups", {})
    key = ("stage", axis)
    if key not in cache:
        names = list(mesh.mesh_dim_names)
        k = names.index(axis)
        rest = [i for i in range(len(names)) if i != k]
        rows = mesh.mesh.permute(*rest, k).reshape(-1, n).tolist()
        me = dist.get_rank()
        for row in rows:
            g = dist.new_group(row, timeout=datetime.timedelta(
                seconds=STAGE_TIMEOUT_S))
            if me in row:
                i = row.index(me)
                cache[key] = StageRing(g, i, n, row[(i - 1) % n],
                                       row[(i + 1) % n])
    return cache[key]


def local_mesh(device_type: Optional[str] = None):
    """A one-axis ``dp`` mesh over the ranks on this host (the
    reference's mesh over ``jax.local_devices()``), as a dim of a
    ``("host", "dp")`` mesh over the world. A collective; every host must
    hold the same number of ranks."""
    import socket

    from torch.distributed.device_mesh import DeviceMesh

    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    order = sorted(set(hosts), key=hosts.index)
    rows = [[r for r, h in enumerate(hosts) if h == host] for host in order]
    if len({len(r) for r in rows}) != 1:
        raise ValueError(f"hosts hold different numbers of ranks: "
                         f"{[len(r) for r in rows]}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    mesh = DeviceMesh(device_type, torch.tensor(rows),
                      mesh_dim_names=("host", "dp"))
    return mesh["dp"]


class Placement(NamedTuple):
    """A DTensor placement: the mesh and one placement for each of its
    dims (the counterpart of a ``NamedSharding``)."""

    mesh: object
    placements: Tuple


def batch_sharding(mesh, axis: str = "dp") -> Placement:
    """A batch's placement: the leading dim split over ``axis``, the
    rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return Placement(mesh, tuple(Shard(0) if a == axis else Replicate()
                                 for a in mesh.mesh_dim_names))


def replicate(mesh) -> Placement:
    from torch.distributed.tensor import Replicate

    return Placement(mesh, tuple(Replicate() for _ in mesh.mesh_dim_names))


def shard_batch(mesh, batch, axis: str = "dp"):
    """This rank's rows of a global batch as DTensors over ``mesh``,
    sharded over ``axis`` (the reference's
    ``make_array_from_process_local_data``): each tensor of ``batch`` (a
    tensor, or a tuple, list or dict of them) is this rank's shard, every
    rank's shard of one size. Nothing is copied or sent."""
    from torch.distributed.tensor import DTensor

    pl = batch_sharding(mesh, axis)

    def wrap(t):
        if isinstance(t, dict):
            return {k: wrap(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(v) for v in t)
        return DTensor.from_local(t, pl.mesh, pl.placements,
                                  run_check=False)

    return wrap(batch)
