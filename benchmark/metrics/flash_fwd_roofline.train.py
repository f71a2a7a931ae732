"""Percent: the bound of the traced train steps' flash forward
launches (``arith.flash_bounds_ms`` at the cell's shapes) over the
device time of the kernels whose names begin ``flash_fwd``."""

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    if run.kind != "train":
        return None
    return run.flash_roofline(("fwd",))
