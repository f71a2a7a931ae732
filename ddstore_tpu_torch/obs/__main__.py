"""ddtrace / ddmetrics CLI: merge per-rank dumps, render postmortem
span trees, print latency tables, and export/watch live metrics
snapshots.

Workflow (README "Distributed tracing & flight recorder" + "Live
metrics & SLOs")::

    # each rank saves its trace dump (live rings or flight snapshot)
    from ddstore_tpu_torch import obs
    obs.save_dump(f"/tmp/trace.r{store.rank}.npy", store.trace_dump())

    # merge into Chrome trace-event JSON (chrome://tracing / Perfetto)
    python -m ddstore_tpu_torch.obs merge -o trace.json /tmp/trace.r*.npy

    # or read the story in the terminal
    python -m ddstore_tpu_torch.obs tree /tmp/trace.r*.npy

    # measured per-(class, route, peer) percentiles from a saved dump
    python -m ddstore_tpu_torch.obs latency /tmp/trace.r*.npy

    # live histogram snapshots (no tracing needed):
    obs.save_metrics(f"/tmp/m.r{store.rank}.npy",
                     store.metrics_snapshot())
    python -m ddstore_tpu_torch.obs top /tmp/m.r*.npy           # one shot
    python -m ddstore_tpu_torch.obs top --watch 2 /tmp/m.r*.npy # refresh
    python -m ddstore_tpu_torch.obs metrics --format prom /tmp/m.r*.npy
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from . import (chrome_trace, latency_text, load_dump, load_metrics,
               merge, merge_metrics, metrics_json, prometheus_text,
               span_latency, span_tree)


def _load_cells(paths):
    cells = []
    for p in paths:
        try:
            cells.append(load_metrics(p))
        except (OSError, ValueError) as e:
            print(f"# skipping {p}: {e}", file=sys.stderr)
    return merge_metrics(cells)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ddstore_tpu_torch.obs",
        description="Merge/render ddstore trace dumps and live "
                    "metrics snapshots.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser(
        "merge", help="merge per-rank .npy dumps into Chrome "
        "trace-event JSON (chrome://tracing, Perfetto)")
    mp.add_argument("dumps", nargs="+", help="per-rank dump .npy files")
    mp.add_argument("-o", "--out", default="-",
                    help="output path (default stdout)")
    tp = sub.add_parser(
        "tree", help="render the merged span tree as text "
        "(postmortems over a flight dump)")
    tp.add_argument("dumps", nargs="+")
    tp.add_argument("--span", type=lambda s: int(s, 16), default=None,
                    help="render one span only (hex id)")
    lp = sub.add_parser(
        "latency", help="measured per-(class, route, peer) latency "
        "percentiles from saved TRACE dumps (span_latency) — the same "
        "report path the live histograms feed")
    lp.add_argument("dumps", nargs="+")
    xp = sub.add_parser(
        "top", help="live-metrics terminal view over saved histogram "
        "snapshots (obs.save_metrics); --watch re-reads and redraws")
    xp.add_argument("snapshots", nargs="+")
    xp.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="re-read the files and redraw every SECS")
    ep = sub.add_parser(
        "metrics", help="export merged histogram snapshots as "
        "Prometheus exposition text or JSON")
    ep.add_argument("snapshots", nargs="+")
    ep.add_argument("--format", choices=("prom", "json"),
                    default="prom")
    ep.add_argument("-o", "--out", default="-",
                    help="output path (default stdout)")
    args = ap.parse_args(argv)

    if args.cmd in ("merge", "tree", "latency"):
        events = merge([load_dump(p) for p in args.dumps])
    if args.cmd == "merge":
        payload = json.dumps(chrome_trace(events))
        if args.out == "-":
            print(payload)
        else:
            with open(args.out, "w") as f:
                f.write(payload)
            print(f"# {len(events)} events -> {args.out}",
                  file=sys.stderr)
    elif args.cmd == "tree":
        print(span_tree(events, span=args.span))
    elif args.cmd == "latency":
        table = span_latency(events)
        head = (f"{'class|route|peer':<28} {'count':>8} "
                f"{'p50_ms':>9} {'p99_ms':>9}")
        print(head)
        print("-" * len(head))
        for key in sorted(table):
            r = table[key]
            print(f"{key:<28} {r['count']:>8} {r['p50_ms']:>9.3f} "
                  f"{r['p99_ms']:>9.3f}")
        if not table:
            print("(no op spans in the dump)")
    elif args.cmd == "top":
        while True:
            cells = _load_cells(args.snapshots)
            text = latency_text(
                cells, title=f"ddmetrics ({len(args.snapshots)} "
                             f"snapshot file(s))")
            if args.watch > 0:
                # ANSI clear+home keeps the table in place like top(1).
                sys.stdout.write("\x1b[2J\x1b[H")
            print(text, flush=True)
            if args.watch <= 0:
                break
            try:
                time.sleep(args.watch)
            except KeyboardInterrupt:
                break
    else:  # metrics
        cells = _load_cells(args.snapshots)
        payload = prometheus_text(cells) if args.format == "prom" \
            else json.dumps(metrics_json(cells), indent=2)
        if args.out == "-":
            print(payload)
        else:
            with open(args.out, "w") as f:
                f.write(payload)
            print(f"# {len(cells)} cell(s) -> {args.out}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
