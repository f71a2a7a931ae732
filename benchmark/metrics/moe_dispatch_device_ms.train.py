"""Device milliseconds a traced train step under the program's
``ddstore:router``, ``ddstore:dispatch`` and ``ddstore:combine`` spans:
the expert layers' routing (logits, scores, top-k, the balance loss), the
sort and gather of the held assignments, and the gated sum, in the
forward."""

KIND = "per_layer"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "moe"
MOVES = "train_tokens_per_s"

SPANS = ("ddstore:router", "ddstore:dispatch", "ddstore:combine")


def read(run):
    spans = (run.records[0].get("trace") or {}).get("spans")
    if run.kind != "train" or not run.on_card or not spans:
        return None
    dev = spans["device_ms"]
    if not any(s in dev for s in SPANS):
        return None
    return sum(dev.get(s, 0.0) for s in SPANS)
