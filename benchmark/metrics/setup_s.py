"""Set-up seconds: from the process's start to the window's (imports,
the kernels' build where they are stale, the corpus into the store, the
weights, the checked and warm-up steps); the slowest rank's."""

KIND = "end_to_end"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return max(r["setup_s"] for r in run.records)
