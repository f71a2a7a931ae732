"""Metrics, checkpointing, and profiler spans."""

from .checkpoint import (load_shard, restore_train_state, save_shard,
                         save_train_state, save_train_state_async)
from .metrics import LatencyHistogram, PipelineMetrics
from .profile import annotate, step_annotate, trace

__all__ = ["LatencyHistogram", "PipelineMetrics", "save_train_state",
           "save_train_state_async", "restore_train_state", "save_shard",
           "load_shard", "trace", "annotate", "step_annotate"]
