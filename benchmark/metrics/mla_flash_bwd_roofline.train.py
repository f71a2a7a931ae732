"""Percent: the bound of the traced train steps' flash dq and dk/dv
launches at latent attention's true head dims (192 and 128) over the
device time of the kernels whose names begin ``flash_bwd_dq`` and
``flash_bwd_dkv``."""

from benchmark.readers_moonlight import mla_flash_roofline

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    return mla_flash_roofline(run, ("dq", "dkv"))
