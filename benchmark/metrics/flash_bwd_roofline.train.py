"""Percent: the bound of the traced train steps' flash dq and dk/dv
launches over the device time of the kernels whose names begin
``flash_bwd_dq`` and ``flash_bwd_dkv``."""

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    if run.kind != "train":
        return None
    return run.flash_roofline(("dq", "dkv"))
