"""The device memory the train step held at its peak in the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), the
fullest rank's."""

KIND = "end_to_end"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    if run.kind != "train" or not run.on_card:
        return None
    return max(r["peak_window_bytes"] for r in run.records) / 2**30
