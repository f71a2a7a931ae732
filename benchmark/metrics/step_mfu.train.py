"""Model FLOPs of the window's train steps (``arith.lm_flops_per_step``:
no recomputation counted) over the window and the cards' bf16 peak
(989 TFLOP/s each)."""

from benchmark import arith

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(run):
    if run.kind != "train" or not run.on_card:
        return None
    flops = run.model_flops_per_step() * run.steps * run.world
    return 100.0 * flops / run.window_s / (arith.PEAK_BF16_FLOPS * run.chips)
