"""Input-pipeline metrics (the port of ``ddstore_tpu/utils/metrics.py``):
latency histograms, the input-pipeline efficiency (the fraction of an
epoch's wall clock the consumer did not spend waiting for a batch), the
bytes-moved ledger (host path and device-collective fetch), the loader's
degraded-mode events, the readahead window accounting, and the
store-sourced per-epoch summaries (scatter plan, faults, failover,
integrity, tiering, live latency, SLOs, gateway, lanes, tenants,
trace) beside the cost-model scheduler's plan."""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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
    """Input-pipeline efficiency: fraction of wall-clock the device did NOT
    wait on data. The loader records how long each ``__next__`` blocked
    (`wait`); the training loop's total span is everything else (compute +
    dispatch). efficiency = 1 - wait/total.

    With a plan source attached (``set_plan_source`` — the loader wires
    its dataset's ``DDStore.plan_stats`` automatically), the summary also
    carries the epoch's scatter-read planner statistics: how well the
    fetch path coalesced/deduped this epoch's batches."""

    #: ledger counters accepted by :meth:`add_bytes` (anything else is
    #: rejected loudly — a typo'd counter must not vanish silently)
    BYTE_KEYS = ("bytes_local_get", "bytes_over_ici", "bytes_over_dcn",
                 "rows_over_ici")

    #: per-window readahead counters accepted by :meth:`add_window`
    WINDOW_KEYS = ("rows_requested", "rows_unique", "dup_rows", "runs",
                   "remote_runs", "peer_lists", "window_bytes")

    #: degraded-mode events accepted by :meth:`add_fault_event` — the
    #: pipeline-level half of the fault story (the native half comes
    #: from the fault source):
    #:   windows_retried          readahead windows re-fetched at
    #:                            per-batch granularity after a
    #:                            transient window-fetch failure
    #:   window_batch_refetches   per-batch refetch requests those
    #:                            retries issued
    #:   readahead_degraded       engines abandoned mid-epoch (loader
    #:                            fell back to per-batch fetch)
    #:   collective_batch_fallbacks  device-collective batches that fell
    #:                            back to the host path on a transient
    #:                            staging failure
    FAULT_EVENT_KEYS = ("windows_retried", "window_batch_refetches",
                        "readahead_degraded", "collective_batch_fallbacks",
                        "admission_deferred_batches")

    def __init__(self, plan_source: Optional[Callable[[], Dict]] = None):
        self.wait = LatencyHistogram("device_wait")
        self.fetch = LatencyHistogram("host_fetch")
        self.stage = LatencyHistogram("device_put")
        # Readahead window accounting: how long the consumer stalled on
        # an unfinished window fetch vs how long staged windows sat
        # ready ahead of need (the overlap headroom), plus the fetch
        # leg's own wall time (issue -> transport completion — the
        # number comparable to bulk-stripe bandwidth).
        self.ra_wait = LatencyHistogram("readahead_consumer_wait")
        self.ra_idle = LatencyHistogram("readahead_producer_idle")
        self.ra_fetch = LatencyHistogram("readahead_window_fetch")
        self._t_start: Optional[float] = None
        self._t_end: Optional[float] = None
        self._plan_source = plan_source
        self._plan_begin: Optional[Dict] = None
        self._plan_end: Optional[Dict] = None
        # Bytes-moved ledger (device-collective fetch vs host path):
        # which link carried this epoch's sample bytes. Guarded — the
        # loader's worker pool records from several threads.
        self._bytes_mu = threading.Lock()
        self._bytes: Dict[str, int] = {k: 0 for k in self.BYTE_KEYS}
        # Per-lane byte ledger (multi-lane TCP transport): a cumulative
        # per-lane-bytes source (DDStore.lane_bytes) snapshotted at
        # epoch boundaries; bytes_moved() reports the per-epoch delta
        # plus the derived lane utilization.
        self._lane_source: Optional[Callable[[], List[int]]] = None
        self._lane_begin: Optional[List[int]] = None
        self._lane_end: Optional[List[int]] = None
        self._ra_mu = threading.Lock()
        self._ra: Dict[str, int] = {k: 0 for k in self.WINDOW_KEYS}
        self._ra_windows = 0
        # Fault accounting: a cumulative-counter source (DDStore.
        # fault_stats — injector draws + native retry layers) snapshotted
        # at epoch boundaries, plus pipeline-level degradation events.
        self._fault_source: Optional[Callable[[], Dict]] = None
        self._fault_begin: Optional[Dict] = None
        self._fault_end: Optional[Dict] = None
        self._fault_mu = threading.Lock()
        self._fault_events: Dict[str, int] = \
            {k: 0 for k in self.FAULT_EVENT_KEYS}
        # Replicated-read failover ledger: a cumulative-counter source
        # (DDStore.failover_stats) snapshotted at epoch boundaries —
        # summary()["failover"] is how an epoch record proves "peer
        # died, replicas served, zero give-ups" on its own.
        self._failover_source: Optional[Callable[[], Dict]] = None
        self._failover_begin: Optional[Dict] = None
        self._failover_end: Optional[Dict] = None
        # (bytes, fetch_s) per window, for the honest per-window best
        # bandwidth (bounded: one entry per window, windows are O(epoch
        # batches / W)).
        self._ra_fetch_samples: List[Tuple[int, float]] = []
        # Cost-model scheduler snapshot source (Scheduler.snapshot):
        # summary()["sched"] is how a bench record explains WHY each
        # transport knob was set this epoch.
        self._sched_source: Optional[Callable[[], Dict]] = None
        # Per-tenant ledger source (DDStore.tenant_stats): snapshotted
        # at epoch boundaries, summary()["tenants"] carries the
        # per-tenant deltas (quota rejections, admissions/deferrals,
        # read/served traffic) plus the live gauges.
        self._tenant_source: Optional[Callable[[], Dict]] = None
        self._tenant_begin: Optional[Dict] = None
        self._tenant_end: Optional[Dict] = None
        # ddtrace source (DDStore.trace_summary): summary()["trace"]
        # carries per-epoch captured/dropped/flight deltas plus the
        # measured span-latency percentiles while tracing is on.
        self._trace_source: Optional[Callable[[], Dict]] = None
        self._trace_counters_source: Optional[Callable[[], Dict]] = None
        self._trace_begin: Optional[Dict] = None
        self._trace_end: Optional[Dict] = None
        # Integrity source (DDStore.integrity_stats): snapshotted at
        # epoch boundaries — summary()["integrity"] is how an epoch
        # record proves "every remote byte verified, N mismatches
        # caught and repaired, zero silent corruption" on its own.
        self._integrity_source: Optional[Callable[[], Dict]] = None
        self._integrity_begin: Optional[Dict] = None
        self._integrity_end: Optional[Dict] = None
        # Tiering source (DDStore.tiering_stats): snapshotted at epoch
        # boundaries — summary()["tiering"] is how an epoch record
        # proves "the hot cache served N% of the window bytes, the
        # cold tier held the rest" on its own.
        self._tiering_source: Optional[Callable[[], Dict]] = None
        self._tiering_begin: Optional[Dict] = None
        self._tiering_end: Optional[Dict] = None
        # ddmetrics source (DDStore.metrics_snapshot — the RAW cell
        # array, not a dict: histograms delta bucket-wise, percentiles
        # don't). summary()["latency"] reports this epoch's live
        # p50/p90/p99 per (class, route, peer, tenant) with tracing
        # off — the always-on latency surface.
        self._latency_source: Optional[Callable[[], object]] = None
        self._latency_begin = None
        self._latency_end = None
        # SLO source (DDStore.slo_summary): summary()["slo"] carries
        # the monitor's per-epoch evaluation/breach deltas plus the
        # last evaluation's breach list.
        self._slo_source: Optional[Callable[[], Dict]] = None
        self._slo_begin: Optional[Dict] = None
        self._slo_end: Optional[Dict] = None
        # Serving-gateway source (DDStore.gateway_stats):
        # summary()["gateway"] carries per-epoch admission/lease deltas
        # (admitted/deferred/rejected, attach/expiry churn) with the
        # session/drain gauges live.
        self._gateway_source: Optional[Callable[[], Dict]] = None
        self._gateway_begin: Optional[Dict] = None
        self._gateway_end: Optional[Dict] = None
        # Device-collective fetch: where its exchange runs and how many
        # exchanges this epoch delivered (None: not a collective pipeline).
        self._collective_device: Optional[str] = None
        self._exchanges = 0

    def set_plan_source(self, source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning cumulative planner
        counters (``DDStore.plan_stats``). Snapshotted at epoch
        boundaries; ``summary()`` reports the per-epoch delta."""
        self._plan_source = source

    def _snap_plan(self) -> Optional[Dict]:
        if self._plan_source is None:
            return None
        try:
            return dict(self._plan_source())
        except Exception:
            # A closed/torn-down store must not sink epoch accounting.
            return None

    def set_fault_source(self, source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning cumulative fault/retry
        counters (``DDStore.fault_stats``). Snapshotted at epoch
        boundaries; ``summary()["faults"]`` reports the per-epoch delta
        alongside the pipeline's own degradation events."""
        self._fault_source = source

    def _snap_faults(self) -> Optional[Dict]:
        if self._fault_source is None:
            return None
        try:
            return dict(self._fault_source())
        except Exception:
            return None

    def add_fault_event(self, **counters: int) -> None:
        """Fold pipeline-level degraded-mode events into the epoch totals
        (:data:`FAULT_EVENT_KEYS`; unknown keys are rejected loudly)."""
        with self._fault_mu:
            for k, v in counters.items():
                if k not in self._fault_events:
                    raise KeyError(f"unknown fault event {k!r}; "
                                   f"expected one of {self.FAULT_EVENT_KEYS}")
                self._fault_events[k] += int(v)

    def fault_summary(self) -> Dict:
        """Per-epoch fault view: native injector/retry counter deltas
        (when a source is attached) + pipeline degradation events."""
        out: Dict = {}
        if self._fault_begin is not None:
            end = self._fault_end if self._fault_end is not None \
                else self._snap_faults()
            if end is not None:
                for k in end:
                    if k == "last_error_peer":
                        out[k] = int(end[k])
                    else:
                        # Clamped at 0: fault_configure() mid-epoch
                        # resets the process-global injector counters
                        # below the epoch baseline, and a negative
                        # "injections this epoch" is nonsense.
                        out[k] = max(0, int(end[k]) - int(
                            self._fault_begin.get(k, 0)))
        with self._fault_mu:
            out.update(self._fault_events)
        return out

    #: gauge keys of the failover source (reported raw, never delta'd —
    #: keep in sync with binding.FAILOVER_GAUGE_KEYS).
    FAILOVER_GAUGES = ("replication", "hb_active", "suspected_now")

    def set_failover_source(self,
                            source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning cumulative failover /
        heartbeat counters (``DDStore.failover_stats``). Snapshotted at
        epoch boundaries; ``summary()["failover"]`` reports per-epoch
        deltas (gauges raw)."""
        self._failover_source = source

    def _snap_failover(self) -> Optional[Dict]:
        if self._failover_source is None:
            return None
        try:
            return dict(self._failover_source())
        except Exception:
            return None

    def failover_summary(self) -> Dict:
        """Per-epoch failover view: counter deltas + the live gauges."""
        out: Dict = {}
        if self._failover_begin is None:
            return out
        end = self._failover_end if self._failover_end is not None \
            else self._snap_failover()
        if end is None:
            return out
        for k in end:
            if k in self.FAILOVER_GAUGES:
                out[k] = int(end[k])
            else:
                out[k] = max(0, int(end[k]) - int(
                    self._failover_begin.get(k, 0)))
        return out

    #: gauge keys of the integrity source (reported raw, never delta'd
    #: — keep in sync with binding.INTEGRITY_GAUGE_KEYS).
    INTEGRITY_GAUGES = ("verify_mode", "sums_tables", "last_corrupt_peer")

    #: gauge keys of the tenant source (reported raw, never delta'd —
    #: keep in sync with binding.TENANT_GAUGE_KEYS).
    TENANT_GAUGES = ("quota_bytes", "quota_vars", "bytes", "vars",
                     "snapshot_pins", "share")

    def set_tenant_source(self,
                          source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning the per-tenant ledger
        (``DDStore.tenant_stats`` — ``{tenant: {counter: value}}``).
        Snapshotted at epoch boundaries; ``summary()["tenants"]``
        reports per-tenant per-epoch deltas (gauges raw) — how an
        epoch record proves "the capped tenant was rejected/deferred,
        the others kept their throughput" on its own."""
        self._tenant_source = source

    def _snap_tenants(self) -> Optional[Dict]:
        if self._tenant_source is None:
            return None
        try:
            return {t: dict(v) for t, v in self._tenant_source().items()}
        except Exception:
            return None

    def tenant_summary(self) -> Dict:
        """Per-epoch tenant view: counter deltas + the live gauges,
        one row per tenant (tenants appearing mid-epoch delta against
        an implicit zero baseline)."""
        out: Dict = {}
        if self._tenant_begin is None:
            return out
        end = self._tenant_end if self._tenant_end is not None \
            else self._snap_tenants()
        if end is None:
            return out
        for tenant, row in end.items():
            begin = self._tenant_begin.get(tenant, {})
            trow: Dict = {}
            for k, v in row.items():
                if k in self.TENANT_GAUGES:
                    trow[k] = int(v)
                else:
                    trow[k] = max(0, int(v) - int(begin.get(k, 0)))
            out[tenant] = trow
        return out

    #: gauge keys of the trace source (reported raw, never delta'd —
    #: keep in sync with binding.TRACE_STAT_KEYS's gauge subset plus
    #: the derived ring_occupancy); "span_latency" (a dict) also
    #: passes through live.
    TRACE_GAUGES = ("enabled", "ring_events", "threads", "capacity",
                    "live", "ring_occupancy", "flight_events")

    def set_trace_source(self, source: Optional[Callable[[], Dict]],
                         counters_source: Optional[Callable[[], Dict]]
                         = None) -> None:
        """Attach a zero-arg callable returning the ddtrace payload
        (``DDStore.trace_summary`` — monotone captured/dropped/flight/
        span counters + ring gauges + measured span-latency
        percentiles). Snapshotted at epoch boundaries;
        ``summary()["trace"]`` reports per-epoch counter deltas with
        the gauges and percentile table live. ``counters_source``, when
        given (``DDStore.trace_stats``), is used for the BEGIN
        snapshot: it only needs the counter scalars, and the full
        source's ring dump + percentile pass would run per epoch start
        for nothing."""
        self._trace_source = source
        self._trace_counters_source = counters_source or source

    def _snap_trace(self, begin: bool = False) -> Optional[Dict]:
        src = self._trace_counters_source if begin else self._trace_source
        if src is None:
            return None
        try:
            return dict(src())
        except Exception:
            return None

    def trace_summary(self) -> Dict:
        """Per-epoch trace view: events captured/dropped this epoch,
        flight-recorder activity, ring occupancy, and the measured
        per-(class, route, peer) span latency percentiles."""
        out: Dict = {}
        if self._trace_begin is None:
            return out
        end = self._trace_end if self._trace_end is not None \
            else self._snap_trace()
        if end is None:
            return out
        for k, v in end.items():
            if k in self.TRACE_GAUGES or k == "span_latency":
                out[k] = v
            else:
                out[k] = max(0, int(v) - int(self._trace_begin.get(k, 0)))
        return out

    #: gauge keys of the integrity source (reported raw, never delta'd
    #: — keep in sync with binding.INTEGRITY_GAUGE_KEYS).
    INTEGRITY_GAUGES = ("verify_mode", "sums_tables", "last_corrupt_peer")

    def set_integrity_source(self,
                             source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning cumulative integrity
        counters (``DDStore.integrity_stats``). Snapshotted at epoch
        boundaries; ``summary()["integrity"]`` reports per-epoch deltas
        (gauges raw)."""
        self._integrity_source = source

    def _snap_integrity(self) -> Optional[Dict]:
        if self._integrity_source is None:
            return None
        try:
            return dict(self._integrity_source())
        except Exception:
            return None

    def integrity_summary(self) -> Dict:
        """Per-epoch integrity view: counter deltas + the live gauges."""
        out: Dict = {}
        if self._integrity_begin is None:
            return out
        end = self._integrity_end if self._integrity_end is not None \
            else self._snap_integrity()
        if end is None:
            return out
        for k in end:
            if k in self.INTEGRITY_GAUGES:
                out[k] = int(end[k])
            else:
                out[k] = max(0, int(end[k]) - int(
                    self._integrity_begin.get(k, 0)))
        return out

    #: gauge keys of the tiering source (reported raw, never delta'd —
    #: keep in sync with binding.TIERING_GAUGE_KEYS).
    TIERING_GAUGES = ("cache_max_bytes", "cache_bytes", "cache_entries",
                      "cold_vars", "cold_bytes")

    def set_tiering_source(self,
                           source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning cumulative tiering
        counters (``DDStore.tiering_stats``). Snapshotted at epoch
        boundaries; ``summary()["tiering"]`` reports per-epoch deltas
        (gauges raw) plus the derived ``cache_hit_rate`` — hit bytes
        over consulted bytes, the number the tiered bench gates on."""
        self._tiering_source = source

    def _snap_tiering(self) -> Optional[Dict]:
        if self._tiering_source is None:
            return None
        try:
            return dict(self._tiering_source())
        except Exception:
            return None

    def tiering_summary(self) -> Dict:
        """Per-epoch tiering view: counter deltas + the live gauges +
        the epoch's byte-weighted cache hit rate."""
        out: Dict = {}
        if self._tiering_begin is None:
            return out
        end = self._tiering_end if self._tiering_end is not None \
            else self._snap_tiering()
        if end is None:
            return out
        for k in end:
            if k in self.TIERING_GAUGES:
                out[k] = int(end[k])
            else:
                out[k] = max(0, int(end[k]) - int(
                    self._tiering_begin.get(k, 0)))
        consulted = out.get("cache_hit_bytes", 0) + \
            out.get("cache_miss_bytes", 0)
        out["cache_hit_rate"] = round(
            out.get("cache_hit_bytes", 0) / consulted, 4) \
            if consulted else 0.0
        return out

    def set_latency_source(self,
                           source: Optional[Callable[[], object]]) \
            -> None:
        """Attach a zero-arg callable returning the live histogram
        cell array (``DDStore.metrics_snapshot``). Snapshotted at
        epoch boundaries; ``summary()["latency"]`` reports THIS
        epoch's per-cell count/mean/p50/p90/p99 (bucket-wise delta,
        then percentiles — the only order that is correct)."""
        self._latency_source = source

    def _snap_latency(self):
        if self._latency_source is None:
            return None
        try:
            return self._latency_source()
        except Exception:
            return None

    def latency_summary(self) -> Dict:
        """Per-epoch live-latency view: the epoch's histogram delta
        rendered as ``obs.latency_table`` rows keyed
        ``"class|route|peer|tenant"``."""
        if self._latency_begin is None and self._latency_source is None:
            return {}
        end = self._latency_end if self._latency_end is not None \
            else self._snap_latency()
        if end is None:
            return {}
        from ..obs import diff_metrics, latency_table

        try:
            return latency_table(diff_metrics(self._latency_begin, end))
        except Exception:
            return {}

    #: gauge keys of the SLO source (reported raw, never delta'd —
    #: keep in sync with binding.SLO_GAUGE_KEYS); "last_breaches" (a
    #: list) also passes through live.
    SLO_GAUGES = ("rules", "window_ms", "last_breach_tenant_slot")

    def set_slo_source(self,
                       source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning the SLO monitor's
        payload (``DDStore.slo_summary``). Snapshotted at epoch
        boundaries; ``summary()["slo"]`` reports per-epoch
        evaluation/breach deltas with the gauges and the last breach
        list live."""
        self._slo_source = source

    def _snap_slo(self) -> Optional[Dict]:
        if self._slo_source is None:
            return None
        try:
            return dict(self._slo_source())
        except Exception:
            return None

    def slo_summary(self) -> Dict:
        """Per-epoch SLO view: evaluations/breaches this epoch plus
        the configured-rule gauges and the most recent breach list."""
        out: Dict = {}
        if self._slo_begin is None:
            return out
        end = self._slo_end if self._slo_end is not None \
            else self._snap_slo()
        if end is None:
            return out
        for k, v in end.items():
            if k in self.SLO_GAUGES or k == "last_breaches":
                out[k] = v
            else:
                out[k] = max(0, int(v) - int(self._slo_begin.get(k, 0)))
        return out

    #: gauge keys of the gateway source (reported raw, never delta'd —
    #: keep in sync with binding.GATEWAY_GAUGE_KEYS).
    GATEWAY_GAUGES = ("enabled", "sessions", "draining", "inflight",
                      "deferred_now", "last_retry_after_ms")

    def set_gateway_source(self,
                           source: Optional[Callable[[], Dict]]) -> None:
        """Attach a zero-arg callable returning the serving gateway's
        counters (``DDStore.gateway_stats``). Snapshotted at epoch
        boundaries; ``summary()["gateway"]`` reports per-epoch
        admission/lease deltas with the session and drain gauges
        live."""
        self._gateway_source = source

    def _snap_gateway(self) -> Optional[Dict]:
        if self._gateway_source is None:
            return None
        try:
            return dict(self._gateway_source())
        except Exception:
            return None

    def gateway_summary(self) -> Dict:
        """Per-epoch gateway view: attach/detach/expiry churn and
        admission verdict deltas (admitted/deferred/rejected/
        drain_sheds), plus the live session/drain gauges."""
        out: Dict = {}
        if self._gateway_begin is None:
            return out
        end = self._gateway_end if self._gateway_end is not None \
            else self._snap_gateway()
        if end is None:
            return out
        for k, v in end.items():
            if k in self.GATEWAY_GAUGES:
                out[k] = v
            else:
                out[k] = max(0, int(v) - int(self._gateway_begin.get(k, 0)))
        return out

    def set_collective(self, exchange_device: str) -> None:
        """Mark this pipeline's batches as delivered by the
        device-collective fetch, whose exchange buffers live on
        ``exchange_device``: ``summary()["collective"]`` then carries it
        beside the epoch's exchange count (:meth:`add_exchange`)."""
        self._collective_device = str(exchange_device)

    def add_exchange(self) -> None:
        """Count one device-collective exchange (one batch delivered)."""
        with self._bytes_mu:
            self._exchanges += 1

    def set_sched_source(self, source: Optional[Callable[[], Dict]]) \
            -> None:
        """Attach a zero-arg callable returning the cost-model
        scheduler's state (``Scheduler.snapshot``): the joint plan
        (route/lanes/depth/width per class), its predicted vs measured
        throughput, the user pins and the replan triggers. Reported
        live in ``summary()["sched"]`` — the loader wires its scheduler
        in automatically."""
        self._sched_source = source

    def set_lane_source(self,
                        source: Optional[Callable[[], List[int]]]) -> None:
        """Attach a zero-arg callable returning cumulative per-lane byte
        totals (``DDStore.lane_bytes``). Snapshotted at epoch
        boundaries; ``bytes_moved()`` then carries ``lane_bytes`` (the
        per-epoch per-lane deltas), ``tcp_lanes_used`` and
        ``lane_utilization`` (delta evenness across the lanes that
        moved bytes: 1.0 = perfectly balanced stripes)."""
        self._lane_source = source

    def _snap_lanes(self) -> Optional[List[int]]:
        if self._lane_source is None:
            return None
        try:
            snap = [int(v) for v in self._lane_source()]
        except Exception:
            return None
        # A backend without lanes (the local transport) reports an
        # empty list: treat it as "no source" so its epoch records
        # don't grow dead lane keys.
        return snap or None

    def add_bytes(self, **counters: int) -> None:
        """Fold one fetch's bytes-moved ledger into the epoch totals
        (``bytes_local_get`` / ``bytes_over_ici`` / ``bytes_over_dcn``
        [+ ``rows_over_ici``] — the device-collective A/B ledger)."""
        with self._bytes_mu:
            for k, v in counters.items():
                if k not in self._bytes:
                    raise KeyError(f"unknown byte counter {k!r}; "
                                   f"expected one of {self.BYTE_KEYS}")
                self._bytes[k] += int(v)

    def bytes_moved(self) -> Dict:
        with self._bytes_mu:
            out: Dict = dict(self._bytes)
        if self._lane_begin is not None:
            # Frozen at epoch_end like the plan/fault snapshots (the
            # next epoch's readahead issuer starts prefetching before
            # the caller reads the summary — a live snapshot would leak
            # its bytes into this epoch's delta); live only mid-epoch.
            end = self._lane_end if self._lane_end is not None \
                else self._snap_lanes()
            if end is not None:
                begin = self._lane_begin
                delta = [max(0, e - (begin[i] if i < len(begin) else 0))
                         for i, e in enumerate(end)]
                used = sum(1 for d in delta if d > 0)
                peak = max(delta, default=0)
                out["lane_bytes"] = delta
                out["tcp_lanes_used"] = used
                # Evenness across the lanes that actually carried bytes:
                # balanced round-robin stripes read ~1.0; a batch that
                # fit one lane reads 1.0 with tcp_lanes_used == 1.
                out["lane_utilization"] = round(
                    sum(delta) / (used * peak), 4) if used and peak \
                    else 0.0
        return out

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
            for k, v in counters.items():
                if k not in self._ra:
                    raise KeyError(f"unknown window counter {k!r}; "
                                   f"expected one of {self.WINDOW_KEYS}")
                self._ra[k] += int(v)

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
        self._plan_begin = self._snap_plan()
        self._plan_end = None
        self._fault_begin = self._snap_faults()
        self._fault_end = None
        self._failover_begin = self._snap_failover()
        self._failover_end = None
        self._tenant_begin = self._snap_tenants()
        self._tenant_end = None
        self._trace_begin = self._snap_trace(begin=True)
        self._trace_end = None
        self._integrity_begin = self._snap_integrity()
        self._integrity_end = None
        self._tiering_begin = self._snap_tiering()
        self._tiering_end = None
        self._latency_begin = self._snap_latency()
        self._latency_end = None
        self._slo_begin = self._snap_slo()
        self._slo_end = None
        self._gateway_begin = self._snap_gateway()
        self._gateway_end = None
        self._lane_begin = self._snap_lanes()
        self._lane_end = None
        with self._bytes_mu:
            self._bytes = {k: 0 for k in self.BYTE_KEYS}
            self._exchanges = 0
        with self._ra_mu:
            self._ra = {k: 0 for k in self.WINDOW_KEYS}
            self._ra_windows = 0
            self._ra_fetch_samples = []
        with self._fault_mu:
            self._fault_events = {k: 0 for k in self.FAULT_EVENT_KEYS}
        self.ra_wait = LatencyHistogram("readahead_consumer_wait")
        self.ra_idle = LatencyHistogram("readahead_producer_idle")
        self.ra_fetch = LatencyHistogram("readahead_window_fetch")

    def epoch_end(self) -> None:
        self._t_end = time.perf_counter()
        self._plan_end = self._snap_plan()
        self._fault_end = self._snap_faults()
        self._failover_end = self._snap_failover()
        self._tenant_end = self._snap_tenants()
        self._trace_end = self._snap_trace()
        self._integrity_end = self._snap_integrity()
        self._tiering_end = self._snap_tiering()
        self._latency_end = self._snap_latency()
        self._slo_end = self._snap_slo()
        self._gateway_end = self._snap_gateway()
        self._lane_end = self._snap_lanes()

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
        if self._plan_begin is not None:
            # Mid-epoch summary: diff against the live counters.
            end = self._plan_end if self._plan_end is not None \
                else self._snap_plan()
            if end is not None:
                out["scatter_plan"] = plan_stats_delta(self._plan_begin, end)
        moved = self.bytes_moved()
        if any(moved.get(k, 0) for k in self.BYTE_KEYS) \
                or moved.get("tcp_lanes_used", 0):
            out["bytes_moved"] = moved
        if self._ra_windows:
            out["readahead"] = self.readahead_summary()
        faults = self.fault_summary()
        # Included whenever a fault source is wired (even all-zero: "no
        # faults this epoch" is itself the result a chaos A/B reads) or
        # any degradation event fired.
        if self._fault_begin is not None or any(faults.values()):
            out["faults"] = faults
        fo = self.failover_summary()
        # Included when replication is actually in force (an R>1 epoch
        # with zero failovers is the "nobody died" result a failover
        # A/B reads) or any failover/suspicion activity fired under R=1
        # heartbeat-only setups.
        if fo and (fo.get("replication", 1) > 1
                   or fo.get("hb_active", 0)
                   or any(v for k, v in fo.items()
                          if k not in self.FAILOVER_GAUGES)):
            out["failover"] = fo
        tn = self.tenant_summary()
        # Included when any tenant beyond the bare default is known, or
        # any tenant activity fired — a multi-tenant epoch's record
        # shows quota/QoS behavior on its own; single-tenant default
        # epochs stay unchanged.
        if tn and (set(tn) != {""} or
                   any(v for k, v in tn.get("", {}).items()
                       if k not in self.TENANT_GAUGES)):
            out["tenants"] = tn
        tr = self.trace_summary()
        # Included while tracing records (the whole payload is the
        # result a trace A/B reads) or if anything was captured this
        # epoch; untraced epochs stay byte-identical.
        if tr and (tr.get("enabled") or tr.get("captured", 0)):
            out["trace"] = tr
        ig = self.integrity_summary()
        # Included while verification/scrubbing is in force (an all-zero
        # mismatch row is the "every byte verified clean" result an
        # integrity A/B reads) or if any counter moved; unverified
        # epochs stay byte-identical.
        if ig and (ig.get("verify_mode")
                   or any(v for k, v in ig.items()
                          if k not in self.INTEGRITY_GAUGES)):
            out["integrity"] = ig
        tg = self.tiering_summary()
        # Included while the hot cache is armed or any cold-tier
        # variable is registered (an all-zero hit row is the "nothing
        # warmed this epoch" result the tiered A/B reads) or if any
        # counter moved; untiered epochs stay byte-identical.
        if tg and (tg.get("cache_max_bytes", 0) > 0
                   or tg.get("cold_vars", 0) > 0
                   or any(v for k, v in tg.items()
                          if k not in self.TIERING_GAUGES
                          and k != "cache_hit_rate")):
            out["tiering"] = tg
        lat = self.latency_summary()
        # Included whenever any cell recorded this epoch: the live
        # latency surface is THE always-on observability product —
        # absent only when metrics are disabled or nothing ran.
        if lat:
            out["latency"] = lat
        slo = self.slo_summary()
        # Included while any objective is configured (an all-zero
        # breach row is the "every tenant met its SLO" result the slo
        # bench reads) or any monitor activity fired.
        if slo and (slo.get("rules", 0) > 0
                    or slo.get("evaluations", 0)
                    or slo.get("breaches", 0)):
            out["slo"] = slo
        gw = self.gateway_summary()
        # Included while the gateway is on (an all-zero verdict row is
        # the "nothing was deferred" result the gateway bench reads) or
        # any session/admission activity fired this epoch.
        if gw and (gw.get("enabled", 0)
                   or gw.get("attaches", 0) or gw.get("admitted", 0)
                   or gw.get("deferred", 0) or gw.get("rejected", 0)):
            out["gateway"] = gw
        if self._collective_device is not None:
            with self._bytes_mu:
                out["collective"] = {
                    "exchange_device": self._collective_device,
                    "exchanges": self._exchanges}
        if self._sched_source is not None:
            # Live (not epoch-frozen): the plan is a current-state view,
            # and a disabled scheduler's {"enabled": False} is itself
            # the A/B fact the sched bench reads.
            try:
                out["sched"] = dict(self._sched_source())
            except Exception:
                pass  # a torn-down store must not sink the summary
        return out
