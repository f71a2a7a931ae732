"""The readings that bound each check's limit from above: the control and
the planted faults, at a cell's own size, on one card.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does (the corpus, the
index order, the weights), computes the plain reference in float32, and
judges against it, by the run's own numbers:

* ``fp8``: the control, the reference in the program's place computed on
  fp8 operands (``reference.py``'s ``prec="fp8"``);
* ``half``: half of each batch left out, the mean taken over the rest;
* ``no_exchange`` (cells over ranks): one rank's rows alone, as a step
  whose gradient all-reduce was left out computes them;
* ``frozen_ln`` and ``frozen_ln_bias``: a step that leaves the LayerNorm
  leaves (and the MLP's biases) unchanged. Their change reads 0 and
  every other number the reference's, so this is the least such a run
  can read.

A state left unchanged reads 1 on ``change_gap`` and needs no run; a
token altered reads at least 1 on ``batch_mismatch``. The benchmark's
runs never run this; it imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import torch

from benchmark import corpus, reference, weights
from benchmark.registry import Registry


def _train_batches(cell: Dict, seed: int, dev) -> List[List[tuple]]:
    """Each rank's (tokens, targets) of the checked steps, as the run's
    ranks read them."""
    t = cell["traffic"]
    world = t.get("ranks", 1)
    order = corpus.order(seed, t["shard_windows"] * world, t["order"])
    out = []
    for r in range(world):
        mine = order[r::world]
        out.append([corpus.windows(
            seed, torch.as_tensor(mine[k * t["rows"]:(k + 1) * t["rows"]],
                                  device=dev), t["seq"],
            cell["config"]["model"]["vocab"])
            for k in range(t["checked_steps"])])
    return out


def _frozen(base, frozen) -> tuple:
    """The reference's numbers with the change of the leaves ``frozen``
    names taken as 0."""
    losses, grad1, change = base
    return losses, grad1, {k: 0.0 if frozen(k) else v
                           for k, v in change.items()}


def _is_ln(k: str) -> bool:
    return k.split(".")[-2].startswith("ln")


def _judge(base, other) -> Dict[str, float]:
    losses, grad1, change = other
    ref_losses, ref_grad1, ref_change = base
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    keep = reference.moving_leaves(ref_grad1)
    return {"loss_gap": loss_gap,
            "grad_gap": reference.worst_leaf_gap(grad1, ref_grad1)[0],
            "change_gap": reference.worst_leaf_gap(change, ref_change,
                                                   keep)[0]}


def train_readings(cell: Dict, seed: int, dev) -> Dict[str, Dict]:
    m, t, w = cell["config"]["model"], cell["traffic"], cell["workload"]
    per_rank = _train_batches(cell, seed, dev)
    glob = [tuple(torch.cat([per_rank[r][k][i] for r in range(len(per_rank))])
                  for i in range(2)) for k in range(t["checked_steps"])]

    def ref(batches, prec="f32"):
        return reference.train(m, lambda: weights.make(m, seed, dev),
                               batches, t["lr"], w["ref_rows"], prec)

    base = ref(glob)
    out = {"reference": {"losses": base[0]},
           "fp8": _judge(base, ref(glob, "fp8")),
           "half": _judge(base, ref([(a[:len(a) // 2], b[:len(b) // 2])
                                     for a, b in glob])),
           "frozen_ln": _judge(base, _frozen(base, _is_ln)),
           "frozen_ln_bias": _judge(base, _frozen(
               base, lambda k: _is_ln(k) or k.endswith(".bias")))}
    if len(per_rank) > 1:
        out["no_exchange"] = _judge(base, ref(per_rank[0]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = Registry().cell(args.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = train_readings(cell, seed, dev)
        rec = {"cell": args.workload, "seed": seed, "readings": got,
               "seconds": time.perf_counter() - t0}
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    names = sorted({v for r in rows for v in r["readings"]
                    if v != "reference"})
    for v in names:
        for k in sorted(rows[0]["readings"][v]):
            xs = [r["readings"][v][k] for r in rows]
            print(f"{args.workload} {v} {k}: min {min(xs)!r} max "
                  f"{max(xs)!r} over {len(xs)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
