"""Parallel layer of the port over ``torch.distributed`` process groups:
device meshes and DTensor placements, ring attention over a
sequence-parallel axis, tensor and expert parallelism, ZeRO-3 through
FSDP2, pipeline schedules over a ``pp`` axis, the epoch-wise global
shuffle and the row exchanges (the port of ``ddstore_tpu/parallel/``:
``mesh.py``, ``ring_attention.py``, ``tp.py``, ``fsdp.py``,
``pipeline.py`` and ``shuffle.py``)."""

from .fsdp import data_axes, fsdp_compose, fsdp_rules, place_zero3
from .mesh import (AXIS_ORDER, Placement, axes_group, batch_sharding,
                   data_parallel_mesh, local_mesh, make_mesh, replicate,
                   shard_batch, stage_ring)
from .pipeline import (interleave_order, interleave_stage_params,
                       pipeline_1f1b, pipeline_apply, pipeline_interleaved,
                       pipeline_interleaved_1f1b, stack_stage_params)
from .ring_attention import ring_attention, ring_self_attention
from .shuffle import (all_to_all_rows, exchange_rows, global_shuffle_epoch,
                      host_global_shuffle, permute_rows,
                      ragged_global_shuffle)
from .tp import (Strided, expert_rules, megatron_rules, pp_stage_rules,
                 shard_pytree, shardings_of, torch_spec)

__all__ = [
    "AXIS_ORDER",
    "make_mesh",
    "data_parallel_mesh",
    "local_mesh",
    "axes_group",
    "Placement",
    "batch_sharding",
    "replicate",
    "shard_batch",
    "stage_ring",
    "ring_attention",
    "ring_self_attention",
    "megatron_rules",
    "expert_rules",
    "pp_stage_rules",
    "Strided",
    "torch_spec",
    "shard_pytree",
    "shardings_of",
    "fsdp_rules",
    "fsdp_compose",
    "place_zero3",
    "data_axes",
    "all_to_all_rows",
    "exchange_rows",
    "permute_rows",
    "global_shuffle_epoch",
    "host_global_shuffle",
    "ragged_global_shuffle",
    "pipeline_apply",
    "pipeline_1f1b",
    "pipeline_interleaved",
    "pipeline_interleaved_1f1b",
    "interleave_stage_params",
    "interleave_order",
    "stack_stage_params",
]
