"""Parallel layer of the port over ``torch.distributed`` process groups:
device meshes, ring attention over a sequence-parallel axis, the
epoch-wise global shuffle and the row exchanges (the port of
``ddstore_tpu/parallel/``: ``mesh.py``, ``ring_attention.py`` and
``shuffle.py``; the TP/FSDP and pipeline layers come with later
slices)."""

from .mesh import AXIS_ORDER, data_parallel_mesh, make_mesh
from .ring_attention import ring_attention, ring_self_attention
from .shuffle import (all_to_all_rows, exchange_rows, global_shuffle_epoch,
                      host_global_shuffle, permute_rows,
                      ragged_global_shuffle)

__all__ = [
    "AXIS_ORDER",
    "make_mesh",
    "data_parallel_mesh",
    "ring_attention",
    "ring_self_attention",
    "all_to_all_rows",
    "exchange_rows",
    "permute_rows",
    "global_shuffle_epoch",
    "host_global_shuffle",
    "ragged_global_shuffle",
]
