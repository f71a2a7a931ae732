"""Percent of the window the step waited for the loader's next batch
(the loader's ``metrics.wait``), the mean over the ranks."""

import numpy as np

KIND = "per_layer"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "loader"
MOVES = "train_tokens_per_s"


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * float(np.mean([r["wait_s"] / r["window_s"]
                                  for r in run.records]))
