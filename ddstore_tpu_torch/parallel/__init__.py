"""Parallel layer of the port: the epoch-wise global shuffle and the row
exchanges over ``torch.distributed`` process groups (the port of
``ddstore_tpu/parallel/shuffle.py``; the meshes, ring attention, TP/FSDP
and pipeline layers come with later slices)."""

from .shuffle import (all_to_all_rows, exchange_rows, global_shuffle_epoch,
                      host_global_shuffle, permute_rows,
                      ragged_global_shuffle)

__all__ = [
    "all_to_all_rows",
    "exchange_rows",
    "permute_rows",
    "global_shuffle_epoch",
    "host_global_shuffle",
    "ragged_global_shuffle",
]
