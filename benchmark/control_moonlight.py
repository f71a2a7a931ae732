"""The readings that bound the limits of ``moonlight-16b-a3b.train`` from
above, at the cell's own size, on one card (``control.py``'s counterpart
for DeepSeek-V3's block).

    python3 -m benchmark.control_moonlight --seeds 11,12,13

For each seed it makes the cell's inputs as a run does (the corpus, the
index order, the weights), computes ``reference_moonlight.py`` in float32,
and judges against it, by the run's own numbers (``loss_gap``,
``grad_gap``, ``change_gap``, ``routing_gap``):

* ``fp8``: the control, the reference on fp8 operands;
* ``softmax``: softmax scores in place of the sigmoid;
* ``gate_bias``: the gates taken from the biased scores;
* ``half``: half of each row's tokens left out of the loss;
* ``frozen_norm``: a step that leaves the RMSNorm scales unchanged (their
  change read as 0, every other number the reference's).

A state left unchanged reads 1 on ``change_gap`` and needs no run. The
benchmark's runs never run this; it imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict

import torch

from benchmark import corpus, reference_moonlight, weights_moonlight
from benchmark.jobs.train_moonlight import judge_moonlight
from benchmark.registry import Registry

CELL = "moonlight-16b-a3b.train"
NUMBERS = ("loss_gap", "grad_gap", "change_gap", "routing_gap")


def _judge(base, other) -> Dict[str, float]:
    """The run's numbers, by the job's own judge, of ``other`` in the
    program's place against ``base``."""
    got = judge_moonlight(other, base)
    return {k: got[k] for k in NUMBERS}


def readings(cell: Dict, seed: int, dev) -> Dict[str, Dict]:
    """Each reading's numbers (the module docstring) on ``seed``'s inputs
    of ``cell``, on ``dev``."""
    m, t = cell["config"]["model"], cell["traffic"]
    order = corpus.order(seed, t["shard_windows"], t["order"])
    batches = [corpus.windows(
        seed, torch.as_tensor(order[k * t["rows"]:(k + 1) * t["rows"]],
                              device=dev), t["seq"], m["vocab"])
        for k in range(t["checked_steps"])]

    def ref(prec="f32", faults=()):
        return reference_moonlight.train(
            m, lambda: weights_moonlight.make(m, seed, dev), batches,
            t["lr"], prec, faults)

    base = ref()
    losses, grad1, change, counts = base
    frozen = {k: 0.0 if "norm" in k or ".ln" in k else v
              for k, v in change.items()}
    out = {"reference": {"losses": losses},
           "frozen_norm": _judge(base, (losses, grad1, frozen, counts))}
    for name, kw in (("fp8", {"prec": "fp8"}),
                     ("softmax", {"faults": ("softmax",)}),
                     ("gate_bias", {"faults": ("gate_bias",)}),
                     ("half", {"faults": ("half",)})):
        out[name] = _judge(base, ref(**kw))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_moonlight")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = Registry().cell(CELL)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = {"cell": CELL, "seed": seed,
               "readings": readings(cell, seed, dev)}
        rec["seconds"] = time.perf_counter() - t0
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    for v in sorted({v for r in rows for v in r["readings"]
                     if v != "reference"}):
        for k in sorted(rows[0]["readings"][v]):
            xs = [r["readings"][v][k] for r in rows]
            print(f"{CELL} {v} {k}: min {min(xs)!r} max {max(xs)!r} over "
                  f"{len(xs)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
