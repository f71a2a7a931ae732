"""Input-pipeline metrics (the part of ``ddstore_tpu/utils/metrics.py``
the loader and the binding need): latency histograms, the input-pipeline
efficiency (the fraction of an epoch's wall clock the consumer did not
spend waiting for a batch), the bytes-moved ledger, the loader's
degraded-mode events, the readahead window accounting and the
scatter-planner deltas."""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LatencyHistogram", "PipelineMetrics", "plan_stats_delta"]


class LatencyHistogram:
    """Streaming latency recorder with percentile summaries. Thread-safe:
    the loader's worker pool records fetch/stage latencies concurrently."""

    def __init__(self, name: str = "latency", max_samples: int = 1 << 16):
        self.name = name
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._mu = threading.Lock()
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        with self._mu:
            self.count += 1
            self.total += seconds
            if len(self._samples) < self.max_samples:
                self._samples.append(seconds)
            else:  # reservoir sampling keeps percentiles honest on long runs
                j = random.randrange(self.count)
                if j < self.max_samples:
                    self._samples[j] = seconds

    def timed(self):
        """Context manager: ``with hist.timed(): ...``"""
        return _Timer(self)

    def percentile(self, q: float) -> float:
        with self._mu:
            xs = sorted(self._samples)
        if not xs:
            return 0.0
        k = min(len(xs) - 1, max(0, int(round(q / 100 * (len(xs) - 1)))))
        return xs[k]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_s": self.mean,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
        }


class _Timer:
    def __init__(self, hist: LatencyHistogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.record(time.perf_counter() - self.t0)


def plan_stats_delta(begin: Dict, end: Dict) -> Dict:
    """Per-window scatter-planner statistics from two cumulative
    ``plan_stats()`` snapshots, with the derived ratios recomputed from
    the deltas: ``plan_coalesce_ratio`` (unique rows per transport run)
    and ``plan_runs_per_peer_list`` (remote runs per per-peer request)."""
    out = {}
    for k in ("plan_batches", "plan_rows", "plan_runs", "plan_local_runs",
              "plan_peer_lists", "plan_dedup_hits", "plan_scratch_runs",
              "plan_scratch_bytes"):
        out[k] = int(end.get(k, 0)) - int(begin.get(k, 0))
    uniq = out["plan_rows"] - out["plan_dedup_hits"]
    out["plan_coalesce_ratio"] = \
        uniq / out["plan_runs"] if out["plan_runs"] else 0.0
    out["plan_runs_per_peer_list"] = \
        (out["plan_runs"] - out["plan_local_runs"]) / out["plan_peer_lists"] \
        if out["plan_peer_lists"] else 0.0
    return out


class PipelineMetrics:
    """Input-pipeline efficiency: the loader records how long each
    ``__next__`` blocked (``wait``), the host gather (``fetch``) and the
    copy to the device (``stage``); efficiency = 1 - wait / epoch wall
    time. Per epoch it also keeps the bytes-moved ledger
    (:meth:`add_bytes`) and the loader's degraded-mode events
    (:meth:`add_fault_event`)."""

    #: counters accepted by :meth:`add_bytes` (the device-collective
    #: fetch's ICI counters come with that slice)
    BYTE_KEYS = ("bytes_over_dcn",)
    #: per-window readahead counters accepted by :meth:`add_window`
    WINDOW_KEYS = ("rows_requested", "rows_unique", "dup_rows", "runs",
                   "remote_runs", "peer_lists", "window_bytes")
    #: events accepted by :meth:`add_fault_event` (the collective
    #: degradation event comes with that slice):
    #:   windows_retried          readahead windows re-fetched at
    #:                            per-batch granularity after a
    #:                            transient window-fetch failure
    #:   window_batch_refetches   per-batch refetch requests those
    #:                            retries issued
    #:   readahead_degraded       engines abandoned mid-epoch (loader
    #:                            fell back to per-batch fetch)
    FAULT_EVENT_KEYS = ("windows_retried", "window_batch_refetches",
                        "readahead_degraded", "admission_deferred_batches")

    def __init__(self):
        self.wait = LatencyHistogram("device_wait")
        self.fetch = LatencyHistogram("host_fetch")
        self.stage = LatencyHistogram("device_put")
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None
        self._mu = threading.Lock()  # the worker pool records concurrently
        self._bytes: Dict[str, int] = dict.fromkeys(self.BYTE_KEYS, 0)
        self._fault_events: Dict[str, int] = \
            dict.fromkeys(self.FAULT_EVENT_KEYS, 0)
        self._ra_mu = threading.Lock()
        self._reset_windows()

    def _reset_windows(self) -> None:
        # Readahead window accounting: how long the consumer stalled on
        # an unfinished window fetch, how long staged windows sat ready
        # before first touch, and each fetch leg's wall time.
        self.ra_wait = LatencyHistogram("readahead_consumer_wait")
        self.ra_idle = LatencyHistogram("readahead_producer_idle")
        self.ra_fetch = LatencyHistogram("readahead_window_fetch")
        with self._ra_mu:
            self._ra: Dict[str, int] = dict.fromkeys(self.WINDOW_KEYS, 0)
            self._ra_windows = 0
            # (bytes, fetch_s) per window, for the per-window best
            # bandwidth
            self._ra_fetch_samples: List[Tuple[int, float]] = []

    @staticmethod
    def _fold(into: Dict[str, int], what: str, counters) -> None:
        for k, v in counters.items():
            if k not in into:
                raise KeyError(f"unknown {what} {k!r}; expected one of "
                               f"{tuple(into)}")
            into[k] += int(v)

    def add_bytes(self, **counters: int) -> None:
        """Fold one fetch's bytes into the epoch's ledger
        (:data:`BYTE_KEYS`; an unknown key raises)."""
        with self._mu:
            self._fold(self._bytes, "byte counter", counters)

    def bytes_moved(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._bytes)

    def add_fault_event(self, **counters: int) -> None:
        """Fold degraded-mode events into the epoch's totals
        (:data:`FAULT_EVENT_KEYS`; an unknown key raises)."""
        with self._mu:
            self._fold(self._fault_events, "fault event", counters)

    def fault_summary(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._fault_events)

    def add_window(self, *, wait_s: float, idle_s: float,
                   fetch_s: float = 0.0, **counters: int) -> None:
        """Fold one readahead window's accounting into the epoch totals:
        ``wait_s`` = consumer stall on the window's fetch, ``idle_s`` =
        how long the staged window sat ready before first touch,
        ``fetch_s`` = the fetch leg's issue→completion wall time, plus
        the :data:`WINDOW_KEYS` counters (rows/dups/runs/peers/bytes)."""
        self.ra_wait.record(wait_s)
        self.ra_idle.record(idle_s)
        self.ra_fetch.record(fetch_s)
        with self._ra_mu:
            self._ra_windows += 1
            if len(self._ra_fetch_samples) < (1 << 16):
                self._ra_fetch_samples.append(
                    (int(counters.get("window_bytes", 0)), fetch_s))
            self._fold(self._ra, "window counter", counters)

    def readahead_summary(self) -> Dict:
        """Per-epoch readahead view: window totals plus the derived
        per-window rates (runs/peer/window is THE transport fan-out a
        window fetch pays) and the stall/idle milliseconds."""
        with self._ra_mu:
            n = self._ra_windows
            out: Dict = {"windows": n}
            out.update(self._ra)
            samples = list(self._ra_fetch_samples)
        out["consumer_wait_ms"] = round(self.ra_wait.total * 1e3, 3)
        out["producer_idle_ms"] = round(self.ra_idle.total * 1e3, 3)
        # Transport-leg bandwidth of the window fetches themselves
        # (issue -> completion), independent of delivery/gather time.
        # The mean is the overlapped steady state (fetch competes with
        # the previous window's delivery for cores/memory bandwidth);
        # `_best` is the fastest window — typically the first of an
        # epoch, fetched with nothing else running — the uncontended
        # transport capability, measured the same way a bulk-stripe
        # benchmark is.
        out["window_fetch_gbps"] = round(
            out["window_bytes"] / self.ra_fetch.total / 1e9, 3) \
            if self.ra_fetch.total > 0 else 0.0
        best = max((b / s for b, s in samples if s > 0 and b > 0),
                   default=0.0)
        if best:
            # Per-window best: each window's OWN bytes over its own
            # fetch time (mean-bytes / min-time would overstate it
            # whenever a short trailing window posts the minimum).
            out["window_fetch_gbps_best"] = round(best / 1e9, 3)
        if n:
            out["runs_per_window"] = round(out["runs"] / n, 2)
            out["runs_per_peer_per_window"] = round(
                out["remote_runs"] / out["peer_lists"], 2) \
                if out["peer_lists"] else 0.0
            out["dedup_fraction"] = round(
                out["dup_rows"] / out["rows_requested"], 4) \
                if out["rows_requested"] else 0.0
        return out

    def epoch_start(self) -> None:
        self._t_start = time.perf_counter()
        self._t_end = None
        with self._mu:
            self._bytes = dict.fromkeys(self.BYTE_KEYS, 0)
            self._fault_events = dict.fromkeys(self.FAULT_EVENT_KEYS, 0)
        self._reset_windows()

    def epoch_end(self) -> None:
        self._t_end = time.perf_counter()

    @property
    def total_s(self) -> float:
        if self._t_start is None:
            return 0.0
        end = self._t_end if self._t_end is not None else time.perf_counter()
        return end - self._t_start

    @property
    def efficiency(self) -> float:
        total = self.total_s
        if total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.wait.total / total)

    def summary(self) -> Dict:
        out = {
            "input_pipeline_efficiency": self.efficiency,
            "total_s": self.total_s,
            "device_wait": self.wait.summary(),
            "host_fetch": self.fetch.summary(),
            "device_put": self.stage.summary(),
        }
        # As the reference: each ledger appears once something moved.
        for key, ledger in (("bytes_moved", self.bytes_moved()),
                            ("faults", self.fault_summary())):
            if any(ledger.values()):
                out[key] = ledger
        if self._ra_windows:
            out["readahead"] = self.readahead_summary()
        return out
