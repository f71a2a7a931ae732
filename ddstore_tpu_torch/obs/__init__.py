"""ddtrace consumer side (the port of ``ddstore_tpu/obs``, over the
port's native core): merge per-rank event dumps into Chrome trace-event
JSON, render span trees for postmortems, and derive the measured
per-class latency percentiles ``summary()["trace"]`` reports.

The native half (``native/trace.{h,cc}``) records fixed-size typed
events into per-thread lock-free rings and snapshots them into a flight
recorder on failure; this package turns those dumps into things a human
(or chrome://tracing / Perfetto) can read:

* :func:`merge` — concatenate per-rank dumps, time-sorted.
* :func:`chrome_trace` — Chrome trace-event JSON (load in
  chrome://tracing or https://ui.perfetto.dev): op/serve legs become
  async begin/end pairs keyed by span id, everything else instants.
* :func:`span_tree` — plain-text per-span rendering for terminal
  postmortems (the flight dump of a killed owner reads as a story:
  retries, the suspect verdict, every replica-rerouted op).
* :func:`span_latency` — measured p50/p99 per (op class, route, peer)
  from op begin/end pairs — replacing ad-hoc guesswork about where a
  read's time went.
* ``python -m ddstore_tpu_torch.obs merge|tree|latency|top|metrics`` —
  the CLI over saved dumps (``save_dump``/``load_dump``: one ``.npy``
  per rank) and histogram snapshots (``save_metrics``).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..binding import (METRICS_BUCKETS, METRICS_CELL_DTYPE,
                       METRICS_ROUTES, TRACE_EVENT_DTYPE,
                       TRACE_FLIGHT_REASONS, TRACE_OP_CLASSES,
                       TRACE_TYPES)

__all__ = ["merge", "chrome_trace", "span_tree", "span_latency",
           "trace_summary", "save_dump", "load_dump",
           "merge_metrics", "diff_metrics", "hist_percentile",
           "latency_table", "latency_text", "prometheus_text",
           "metrics_json", "save_metrics", "load_metrics"]


def save_dump(path: str, events: np.ndarray) -> str:
    """Persist one rank's dump (``DDStore.trace_dump()`` /
    ``trace_flight_dump()``) as a ``.npy`` the merge CLI consumes."""
    arr = np.asarray(events, dtype=TRACE_EVENT_DTYPE)
    np.save(path, arr)
    return path if path.endswith(".npy") else path + ".npy"


def load_dump(path: str) -> np.ndarray:
    arr = np.load(path)
    if arr.dtype != TRACE_EVENT_DTYPE:
        raise ValueError(f"{path}: not a ddstore trace dump "
                         f"(dtype {arr.dtype})")
    return arr


def merge(dumps: Iterable[np.ndarray]) -> np.ndarray:
    """Concatenate per-rank dumps into one time-sorted stream. Ranks of
    ONE machine share CLOCK_MONOTONIC (the in-process ThreadGroup and
    local FileGroup cases); across hosts the order is per-rank exact,
    cross-rank approximate — spans, not clocks, carry the causality."""
    arrs = [np.asarray(d, dtype=TRACE_EVENT_DTYPE) for d in dumps]
    if not arrs:
        return np.empty(0, dtype=TRACE_EVENT_DTYPE)
    cat = np.concatenate(arrs)
    return cat[np.argsort(cat["t_ns"], kind="stable")]


def _event_name(ev) -> str:
    t = TRACE_TYPES.get(int(ev["type"]), f"type{int(ev['type'])}")
    if t in ("op_begin", "op_end"):
        cls = TRACE_OP_CLASSES.get(int(ev["a"]), str(int(ev["a"])))
        return f"op:{cls}"
    if t in ("serve_begin", "serve_end"):
        return "serve"
    return t


def _args_of(ev) -> Dict:
    t = TRACE_TYPES.get(int(ev["type"]), "")
    a, b, c = int(ev["a"]), int(ev["b"]), int(ev["c"])
    if t == "op_begin":
        return {"class": TRACE_OP_CLASSES.get(a, a), "peer": b,
                "bytes": c}
    if t == "op_end":
        return {"class": TRACE_OP_CLASSES.get(a, a), "rc": b, "bytes": c}
    if t == "retry":
        return {"peer": a, "attempt": b, "rc": c}
    if t == "backoff":
        return {"peer": a, "sleep_ms": b, "attempt": c}
    if t in ("lane_dial", "lane_close"):
        return {"lane": a, "uds" if t == "lane_dial" else "rc": b}
    if t == "serve_begin":
        return {"src": a, "ops": b, "bytes": c}
    if t == "serve_end":
        return {"src": a, "status": b, "bytes": c}
    if t == "cma_read":
        return {"peer": a, "ops": b, "bytes": c}
    if t == "window_issue":
        return {"window": a, "rows": b, "bytes": c}
    if t == "window_ready":
        return {"window": a, "bytes": b, "fetch_us": c}
    if t == "window_stall":
        return {"window": a, "stall_us": c}
    if t in ("suspect", "suspect_clear"):
        return {"peer": a, "source": "ladder" if b else "heartbeat"}
    if t == "quota_reject":
        return {"bytes": a}
    if t == "lane_budget_rotate":
        return {"lanes": a, "rotation": b}
    if t == "flight":
        return {"reason": TRACE_FLIGHT_REASONS.get(a, a)}
    if t == "failover":
        return {"dead_owner": a, "served_by": b, "ops": c}
    if t == "plan_applied":
        return {"replan": a, "engaged": b, "depth": c}
    return {"a": a, "b": b, "c": c}


def chrome_trace(events: np.ndarray) -> List[Dict]:
    """Chrome trace-event JSON array. Ops and serve legs become async
    begin/end pairs keyed by span id (nesting renders in Perfetto's
    async tracks); everything else becomes an instant event. pid =
    rank, tid = native thread id."""
    events = np.asarray(events, dtype=TRACE_EVENT_DTYPE)
    if events.size == 0:
        return []
    t0 = int(events["t_ns"].min())
    out: List[Dict] = []
    begin = {"op_begin", "serve_begin", "window_issue"}
    end = {"op_end", "serve_end", "window_ready"}
    for ev in events:
        t = TRACE_TYPES.get(int(ev["type"]), "")
        rec = {
            "name": _event_name(ev),
            "cat": "ddstore",
            "ts": (int(ev["t_ns"]) - t0) / 1e3,  # microseconds
            "pid": int(ev["rank"]),
            "tid": int(ev["tid"]),
            "args": _args_of(ev),
        }
        span = int(ev["span"])
        if span and t in begin:
            rec["ph"] = "b"
            rec["id"] = f"{span:x}"
        elif span and t in end:
            rec["ph"] = "e"
            rec["id"] = f"{span:x}"
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
            if span:
                rec["args"]["span"] = f"{span:x}"
        out.append(rec)
    return out


def span_tree(events: np.ndarray, span: Optional[int] = None,
              max_spans: int = 50) -> str:
    """Plain-text postmortem rendering: one block per span (time
    order), every event on its own line with rank/thread/timing — the
    flight dump of a failed read names the dead peer, the suspect
    verdict and each replica-rerouted op in one read."""
    events = np.asarray(events, dtype=TRACE_EVENT_DTYPE)
    if events.size == 0:
        return "(no events)"
    events = events[np.argsort(events["t_ns"], kind="stable")]
    t0 = int(events["t_ns"].min())
    by_span: Dict[int, List] = {}
    loose: List = []
    for ev in events:
        s = int(ev["span"])
        if span is not None and s != span:
            continue
        (by_span.setdefault(s, []) if s else loose).append(ev)
    lines: List[str] = []

    def fmt(ev, indent="  "):
        dt_ms = (int(ev["t_ns"]) - t0) / 1e6
        args = ", ".join(f"{k}={v}" for k, v in _args_of(ev).items())
        return (f"{indent}+{dt_ms:9.3f}ms r{int(ev['rank'])}/t"
                f"{int(ev['tid'])} {_event_name(ev)} ({args})")

    shown = 0
    for s, evs in sorted(by_span.items(),
                         key=lambda kv: int(kv[1][0]["t_ns"])):
        if shown >= max_spans:
            lines.append(f"... {len(by_span) - shown} more span(s)")
            break
        shown += 1
        lines.append(f"span {s:x}:")
        lines.extend(fmt(ev) for ev in evs)
    if loose and span is None:
        lines.append("(unspanned):")
        lines.extend(fmt(ev) for ev in loose)
    return "\n".join(lines)


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(q / 100 * (len(xs) - 1)))))
    return xs[k]


def span_latency(events: np.ndarray) -> Dict[str, Dict]:
    """Measured op latency percentiles per ``(class, route, peer)``
    from op begin/end pairs — ``class`` the op kind, ``route`` derived
    from the span's transport events (``cma`` when a CMA read served
    it, ``tcp`` when a wire/serve leg did, else ``local``), ``peer``
    the begin event's target (-1 = multi-peer). Keys are
    ``"class|route|peer"``; values carry count/p50_ms/p99_ms."""
    events = np.asarray(events, dtype=TRACE_EVENT_DTYPE)
    begins: Dict = {}
    route: Dict = {}
    samples: Dict[str, List[float]] = {}
    for ev in events[np.argsort(events["t_ns"], kind="stable")]:
        t = TRACE_TYPES.get(int(ev["type"]), "")
        s = int(ev["span"])
        if not s:
            continue
        if t == "cma_read":
            route[s] = "cma"
        elif t in ("serve_begin", "serve_end", "lane_dial", "retry") \
                and route.get(s) != "cma":
            route[s] = "tcp"
        if t == "op_begin":
            key = (s, int(ev["a"]))
            # First begin wins: async issue -> completion is THE span
            # latency; nested execution legs refine the route only.
            begins.setdefault(key, (int(ev["t_ns"]), int(ev["b"])))
        elif t == "op_end":
            key = (s, int(ev["a"]))
            if key not in begins:
                continue
            t_begin, peer = begins[key]
            cls = TRACE_OP_CLASSES.get(int(ev["a"]), str(int(ev["a"])))
            k = f"{cls}|{route.get(s, 'local')}|{peer}"
            samples.setdefault(k, []).append(
                (int(ev["t_ns"]) - t_begin) / 1e6)
    return {
        k: {"count": len(v),
            "p50_ms": round(_percentile(v, 50), 4),
            "p99_ms": round(_percentile(v, 99), 4)}
        for k, v in samples.items()}


# -- ddmetrics: live histogram cells (merge / percentiles / exporters) -------
#
# The native half (metrics_hist.{h,cc}) keeps per-store log2-bucketed
# latency/bytes histograms per (op class, route, peer, reading tenant);
# this half merges per-rank snapshots into one cluster view, derives
# percentiles, and renders them for humans (terminal table), Prometheus
# scrapers (exposition text) and dashboards (JSON).


def save_metrics(path: str, cells: np.ndarray) -> str:
    """Persist one rank's histogram snapshot
    (``DDStore.metrics_snapshot()``) as a ``.npy`` the metrics CLI
    consumes (``python -m ddstore_tpu_torch.obs top``)."""
    arr = np.asarray(cells, dtype=METRICS_CELL_DTYPE)
    np.save(path, arr)
    return path if path.endswith(".npy") else path + ".npy"


def load_metrics(path: str) -> np.ndarray:
    arr = np.load(path)
    if arr.dtype != METRICS_CELL_DTYPE:
        raise ValueError(f"{path}: not a ddstore metrics snapshot "
                         f"(dtype {arr.dtype})")
    return arr


def _cell_key(c) -> tuple:
    return (int(c["cls"]), int(c["route"]), int(c["peer"]),
            bytes(c["tenant"]))


def merge_metrics(snapshots: Iterable[np.ndarray]) -> np.ndarray:
    """Merge per-rank cell snapshots into one cluster view: cells with
    equal (class, route, peer, tenant) keys sum bucket-wise —
    histograms compose exactly, unlike percentiles."""
    out: Dict[tuple, np.ndarray] = {}
    for snap in snapshots:
        snap = np.asarray(snap, dtype=METRICS_CELL_DTYPE)
        for c in snap:
            k = _cell_key(c)
            if k in out:
                acc = out[k]
                for f in ("count", "lat_sum_ns", "bytes_sum", "lat",
                          "bytes"):
                    acc[f] += c[f]
            else:
                out[k] = c.copy()
    if not out:
        return np.empty(0, dtype=METRICS_CELL_DTYPE)
    return np.array([out[k] for k in sorted(out)],
                    dtype=METRICS_CELL_DTYPE)


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


def latency_text(cells: np.ndarray, title: str = "live latency") -> str:
    """Terminal rendering of :func:`latency_table` (the ``obs top``
    view and the ``obs latency`` report's sibling)."""
    table = latency_table(cells)
    head = (f"{'class|route|peer|tenant':<36} {'count':>8} "
            f"{'mean_ms':>9} {'p50_ms':>9} {'p90_ms':>9} "
            f"{'p99_ms':>9} {'MB':>9}")
    lines = [f"# {title}", head, "-" * len(head)]
    for key in sorted(table):
        r = table[key]
        lines.append(
            f"{key:<36} {r['count']:>8} {r['mean_ms']:>9.3f} "
            f"{r['p50_ms']:>9.3f} {r['p90_ms']:>9.3f} "
            f"{r['p99_ms']:>9.3f} {r['bytes'] / 1e6:>9.2f}")
    if not table:
        lines.append("(no samples)")
    return "\n".join(lines)


def _prom_escape(v: str) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote and newline must be escaped or the scraper rejects the whole
    scrape, not just the one series."""
    return v.replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")


def prometheus_text(cells: np.ndarray,
                    prefix: str = "ddstore") -> str:
    """Prometheus exposition text: one classic histogram per cell
    (``<prefix>_op_latency_seconds`` with cumulative ``le`` buckets,
    ``_sum``/``_count``) plus ``<prefix>_op_bytes_total``. Labels:
    class/route/peer/tenant."""
    cells = np.asarray(cells, dtype=METRICS_CELL_DTYPE)
    lines = [
        f"# HELP {prefix}_op_latency_seconds "
        f"Store op latency (log2 buckets).",
        f"# TYPE {prefix}_op_latency_seconds histogram",
    ]
    byte_lines = [
        f"# HELP {prefix}_op_bytes_total Bytes delivered by store ops.",
        f"# TYPE {prefix}_op_bytes_total counter",
    ]
    for c in cells:
        n = int(c["count"])
        if n == 0:
            continue
        cls = TRACE_OP_CLASSES.get(int(c["cls"]), str(int(c["cls"])))
        route = METRICS_ROUTES.get(int(c["route"]),
                                   str(int(c["route"])))
        tenant = _prom_escape(bytes(c["tenant"]).split(b"\0", 1)[0]
                              .decode(errors="replace"))
        labels = (f'class="{cls}",route="{route}",'
                  f'peer="{int(c["peer"])}",tenant="{tenant}"')
        cum = 0
        for b in range(METRICS_BUCKETS):
            v = int(c["lat"][b])
            if v == 0:
                continue
            cum += v
            le = (1 << (b + 1)) / 1e9
            lines.append(f"{prefix}_op_latency_seconds_bucket"
                         f"{{{labels},le=\"{le:g}\"}} {cum}")
        lines.append(f"{prefix}_op_latency_seconds_bucket"
                     f"{{{labels},le=\"+Inf\"}} {n}")
        # Full ns precision (never %g): at 6 significant digits a
        # long-lived sum stops moving between scrapes and
        # rate(..._sum) flatlines while ops are flowing.
        lines.append(f"{prefix}_op_latency_seconds_sum{{{labels}}} "
                     f"{int(c['lat_sum_ns']) / 1e9:.9f}")
        lines.append(f"{prefix}_op_latency_seconds_count{{{labels}}} "
                     f"{n}")
        byte_lines.append(f"{prefix}_op_bytes_total{{{labels}}} "
                          f"{int(c['bytes_sum'])}")
    return "\n".join(lines + byte_lines) + "\n"


def metrics_json(cells: np.ndarray) -> Dict:
    """JSON-serializable dump of the cells: the latency table plus the
    raw bucket arrays (dashboards re-bucket/re-aggregate from these)."""
    cells = np.asarray(cells, dtype=METRICS_CELL_DTYPE)
    out: Dict = {"buckets": METRICS_BUCKETS, "cells": {}}
    for c in cells:
        if int(c["count"]) == 0:
            continue
        out["cells"][_cell_label(c)] = {
            "count": int(c["count"]),
            "lat_sum_ns": int(c["lat_sum_ns"]),
            "lat": [int(v) for v in c["lat"]],
            "bytes_sum": int(c["bytes_sum"]),
            "bytes": [int(v) for v in c["bytes"]],
        }
    return out


def trace_summary(stats: Dict, events: Optional[np.ndarray] = None) -> Dict:
    """The ``summary()["trace"]`` payload: the counter snapshot
    (:func:`ddstore_tpu_torch.binding.trace_stats`) plus ring occupancy and —
    when ``events`` is given — the measured per-(class, route, peer)
    span latency percentiles."""
    out = dict(stats)
    cap = int(out.get("capacity", 0))
    out["ring_occupancy"] = round(int(out.get("live", 0)) / cap, 4) \
        if cap else 0.0
    if events is not None and len(events):
        out["span_latency"] = span_latency(events)
    return out
