"""Model FLOPs of the window's train steps of DeepSeek-V3's block
(``arith_moonlight.flops_per_step`` at the true widths, with the held
assignments the program counted in the window, no recomputation) over the
window and the card's bf16 peak (989 TFLOP/s)."""

from benchmark import arith, arith_moonlight

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(run):
    moe = run.records[0].get("moe")
    if run.kind != "train" or not run.on_card or not moe \
            or "qk_nope" not in run.model:
        return None
    t = run.traffic
    flops = arith_moonlight.flops_per_step(
        run.model, t["rows"], t["seq"], moe["held_per_step"]) * run.steps
    return 100.0 * flops / run.window_s / (arith.PEAK_BF16_FLOPS * run.chips)
