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
``shard_batch`` are GSPMD placements of whole arrays; their counterparts
are DTensor placements, which come with tensor parallelism and FSDP.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["AXIS_ORDER", "make_mesh", "data_parallel_mesh", "axis_size",
           "axis_index"]

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
