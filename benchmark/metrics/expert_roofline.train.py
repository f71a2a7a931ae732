"""Percent: the bound of the held experts' products in the traced train
steps (``arith_moonlight.expert_bound_ms`` over the held assignments the
program counted in those steps) over the device time of the program's
``ddstore:experts`` and ``ddstore:experts_bwd`` spans, which hold the
experts' grouped products, their weights' casts and the SwiGLU."""

from benchmark import arith_moonlight

KIND = "per_layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "moe"
MOVES = "train_tokens_per_s"


def read(run):
    r = run.records[0]
    spans = (r.get("trace") or {}).get("spans")
    held = r.get("moe_traced")
    if run.kind != "train" or not run.on_card or not spans or not held:
        return None
    dev = spans["device_ms"]
    took = dev.get("ddstore:experts", 0.0) + dev.get("ddstore:experts_bwd",
                                                      0.0)
    if took <= 0:
        return None
    need = arith_moonlight.expert_bound_ms(run.model, held["held_per_step"])
    return 100.0 * need / took
