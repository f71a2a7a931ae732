"""Percent: the bound of the traced train steps' flash forward launches
at latent attention's true head dims (``arith_moonlight.flash_bounds_ms``:
q and k 192 wide, v 128) over the device time of the kernels whose names
begin ``flash_fwd``. The kernels run v zero-padded to 192, so the padding
shows here as a lower share."""

from benchmark.readers_moonlight import mla_flash_roofline

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_tokens_per_s"


def read(run):
    return mla_flash_roofline(run, ("fwd",))
