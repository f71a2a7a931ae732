"""Percent of the traced window (first to last device event of the
traced train steps) in which no kernel or copy ran, the mean over the
ranks."""

import numpy as np

KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(run):
    ts = run.traces()
    if run.kind != "train" or ts is None:
        return None
    return 100.0 * float(np.mean([1 - t["busy_s"] / t["window_s"]
                                  for t in ts]))
