"""Consumer side of the store's live latency histograms (the port of the
ddmetrics half of ``ddstore_tpu/obs``): per-window deltas of a store's
cumulative cell snapshots and the ``summary()["latency"]`` table. The
trace-dump consumers (Chrome trace JSON, span trees, Prometheus text,
the CLI) come with the store's ``trace_summary``/``metrics_summary``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..binding import (METRICS_BUCKETS, METRICS_CELL_DTYPE,
                       METRICS_ROUTES, TRACE_OP_CLASSES)

__all__ = ["diff_metrics", "hist_percentile", "latency_table"]


def _cell_key(c) -> tuple:
    return (int(c["cls"]), int(c["route"]), int(c["peer"]),
            bytes(c["tenant"]))


def diff_metrics(begin: Optional[np.ndarray],
                 end: np.ndarray) -> np.ndarray:
    """Per-window delta of two cumulative snapshots of ONE store
    (``end - begin`` bucket-wise; cells absent from ``begin`` delta
    against zero). Counters are monotone EXCEPT across a
    ``metrics_reset()``: a field that fell below its baseline reads as
    "the window restarted at zero" (the raw end value), never as a
    wrapped ~2^64 uint — the same clamp the native SLO window applies."""
    end = np.asarray(end, dtype=METRICS_CELL_DTYPE)
    if begin is None or len(begin) == 0:
        return end.copy()
    base = {_cell_key(c): c for c in
            np.asarray(begin, dtype=METRICS_CELL_DTYPE)}
    rows = []
    for c in end:
        b = base.get(_cell_key(c))
        d = c.copy()
        if b is not None:
            for f in ("count", "lat_sum_ns", "bytes_sum"):
                d[f] = d[f] - b[f] if d[f] >= b[f] else d[f]
            for f in ("lat", "bytes"):
                d[f] = np.where(d[f] >= b[f], d[f] - b[f], d[f])
        if int(d["count"]) > 0:
            rows.append(d)
    return np.array(rows, dtype=METRICS_CELL_DTYPE) if rows \
        else np.empty(0, dtype=METRICS_CELL_DTYPE)


def hist_percentile(hist, q: float) -> int:
    """The q-th percentile of a log2-bucketed histogram, reported as
    the quantile bucket's UPPER bound (ns/bytes) — conservative, and
    within one log2 bucket of the exact value by construction. 0 when
    the histogram is empty."""
    hist = np.asarray(hist, dtype=np.uint64)
    n = int(hist.sum())
    if n == 0:
        return 0
    want = -(-n * q // 100)  # ceil(q/100 * n)
    cum = 0
    for b, v in enumerate(hist):
        cum += int(v)
        if cum >= want:
            return 1 << (b + 1)
    return 1 << METRICS_BUCKETS


def _cell_label(c) -> str:
    cls = TRACE_OP_CLASSES.get(int(c["cls"]), str(int(c["cls"])))
    route = METRICS_ROUTES.get(int(c["route"]), str(int(c["route"])))
    tenant = bytes(c["tenant"]).split(b"\0", 1)[0].decode(
        errors="replace")
    return f"{cls}|{route}|{int(c['peer'])}|{tenant}"


def latency_table(cells: np.ndarray) -> Dict[str, Dict]:
    """``summary()["latency"]``'s payload: one row per cell keyed
    ``"class|route|peer|tenant"`` with count, mean and conservative
    p50/p90/p99 (bucket upper bounds, ms) plus the bytes side."""
    cells = np.asarray(cells, dtype=METRICS_CELL_DTYPE)
    out: Dict[str, Dict] = {}
    for c in cells:
        n = int(c["count"])
        if n == 0:
            continue
        row = {
            "count": n,
            "mean_ms": round(int(c["lat_sum_ns"]) / n / 1e6, 4),
            "p50_ms": round(hist_percentile(c["lat"], 50) / 1e6, 4),
            "p90_ms": round(hist_percentile(c["lat"], 90) / 1e6, 4),
            "p99_ms": round(hist_percentile(c["lat"], 99) / 1e6, 4),
            "bytes": int(c["bytes_sum"]),
            "p99_bytes": hist_percentile(c["bytes"], 99),
        }
        out[_cell_label(c)] = row
    return out
