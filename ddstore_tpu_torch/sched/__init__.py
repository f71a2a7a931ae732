"""Unified cost-model scheduler (the port of ``ddstore_tpu/sched``).

One measurement substrate (:mod:`.measure`, mirroring the native
``measure.h`` contract) feeds one planner (:mod:`.planner`) that models
delivered batch throughput as a joint function of route x lane width x
readahead depth x async admission width per traffic class, with every
pre-existing env knob acting as a user pin (:mod:`.knobs`)."""

from .knobs import PLANNED_KNOBS, REGISTRY, pinned_knobs
from .measure import (WARM_EWMA_ALPHA, WARM_MAX_COLD_SKIPS,
                      WARM_MIN_SAMPLES, ColdSkipBudget, Fold,
                      ProbeDiscard, SampleSet, WarmStat,
                      fold_warm_sample)
from .planner import (ASYNC_WIDTH_CAP, CostModel, Plan, Scheduler,
                      scheduler_enabled)

__all__ = [
    "ASYNC_WIDTH_CAP", "PLANNED_KNOBS", "REGISTRY", "WARM_EWMA_ALPHA",
    "WARM_MAX_COLD_SKIPS", "WARM_MIN_SAMPLES", "ColdSkipBudget",
    "CostModel", "Fold", "Plan", "ProbeDiscard", "SampleSet",
    "Scheduler", "WarmStat", "fold_warm_sample", "pinned_knobs",
    "scheduler_enabled",
]
