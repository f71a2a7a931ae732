"""The median of the loader's ``metrics.fetch`` over the window: the
store's batched read of a batch's rows into pinned memory (host clock,
timed by the program), over every rank's fetches."""

import numpy as np

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "store"
MOVES = "train_step_ms_p90"


def read(run):
    if run.kind != "train":
        return None
    xs = [x for r in run.records for x in r["fetch_s"]]
    return float(np.median(xs)) * 1e3 if xs else None
