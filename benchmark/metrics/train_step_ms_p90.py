"""The 90th percentile over the window's steps of the time between
consecutive step ends, from CUDA events recorded after each step (no
host wait a step); each step's the slowest rank's."""

import numpy as np

KIND = "end_to_end"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    if run.kind != "train" or not run.on_card:
        return None
    return float(np.percentile(run.step_ms(), 90))
