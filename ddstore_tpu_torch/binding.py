"""ctypes binding over the port's copy of the native store core (the
port of ``ddstore_tpu/binding.py:31-1616``, loading
``libddstore_torch.so`` built by :mod:`ddstore_tpu_torch._build`).

numpy buffers cross as raw pointers with zero copies on the Python side;
the native core is dtype-agnostic (rows are byte spans), so dtype
bookkeeping lives in :mod:`ddstore_tpu_torch.store`. ctypes releases the
GIL for the duration of every foreign call, so remote reads, batched
fetches and barriers never block Python threads (the serving threads are
pure C++).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from ._build import build

_lib: Optional[ctypes.CDLL] = None

_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.dds_create_local.restype = ctypes.c_void_p
    lib.dds_create_local.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.dds_create_tcp.restype = ctypes.c_void_p
    lib.dds_create_tcp.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.dds_server_port.restype = ctypes.c_int
    lib.dds_server_port.argtypes = [ctypes.c_void_p]
    lib.dds_set_peers.restype = ctypes.c_int
    lib.dds_set_peers.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.dds_update_peer.restype = ctypes.c_int
    lib.dds_update_peer.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.dds_barrier_seq.restype = _i64
    lib.dds_barrier_seq.argtypes = [ctypes.c_void_p]
    lib.dds_routing_state.restype = ctypes.c_int
    lib.dds_routing_state.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), _i64p, _i64p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dds_set_barrier_seq.restype = ctypes.c_int
    lib.dds_set_barrier_seq.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_add.restype = ctypes.c_int
    lib.dds_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                            _i64, _i64, _i64, _i64p, ctypes.c_int]
    lib.dds_init.restype = ctypes.c_int
    lib.dds_init.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _i64, _i64,
                             _i64, _i64p]
    lib.dds_update.restype = ctypes.c_int
    lib.dds_update.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_void_p, _i64, _i64]
    lib.dds_get.restype = ctypes.c_int
    lib.dds_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                            _i64, _i64, ctypes.c_char_p]
    lib.dds_get_batch.restype = ctypes.c_int
    lib.dds_get_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_void_p, _i64p, _i64,
                                  ctypes.c_char_p]
    lib.dds_get_batch_async.restype = _i64
    lib.dds_get_batch_async.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_void_p, _i64p, _i64,
                                        ctypes.c_char_p]
    lib.dds_read_runs_async.restype = _i64
    lib.dds_read_runs_async.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_void_p, _i64p, _i64p,
                                        _i64p, _i64p, _i64,
                                        ctypes.c_char_p]
    lib.dds_async_wait.restype = ctypes.c_int
    lib.dds_async_wait.argtypes = [ctypes.c_void_p, _i64, _i64,
                                   ctypes.POINTER(ctypes.c_double)]
    lib.dds_async_release.restype = ctypes.c_int
    lib.dds_async_release.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_async_pending.restype = _i64
    lib.dds_async_pending.argtypes = [ctypes.c_void_p]
    lib.dds_query.restype = ctypes.c_int
    lib.dds_query.argtypes = [ctypes.c_void_p, ctypes.c_char_p, _i64p, _i64p,
                              _i64p, _i64p]
    for fn in ("dds_epoch_begin", "dds_epoch_end", "dds_fence_reset"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.dds_set_epoch_collective.restype = ctypes.c_int
    lib.dds_set_epoch_collective.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dds_set_ifaces.restype = ctypes.c_int
    lib.dds_set_ifaces.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dds_rebind.restype = ctypes.c_int
    lib.dds_rebind.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_void_p]
    lib.dds_free_var.restype = ctypes.c_int
    lib.dds_free_var.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dds_barrier.restype = ctypes.c_int
    lib.dds_barrier.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_cma_ops.restype = _i64
    lib.dds_cma_ops.argtypes = [ctypes.c_void_p]
    lib.dds_uds_conns.restype = _i64
    lib.dds_uds_conns.argtypes = [ctypes.c_void_p]
    lib.dds_plan_stats.restype = ctypes.c_int
    lib.dds_plan_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_lane_state.restype = ctypes.c_int
    lib.dds_lane_state.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_lane_bytes.restype = ctypes.c_int
    lib.dds_lane_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int, _i64p,
                                   ctypes.c_int]
    lib.dds_set_retry_deadline.restype = ctypes.c_int
    lib.dds_set_retry_deadline.argtypes = [ctypes.c_void_p,
                                           ctypes.c_double]
    lib.dds_sched_cells.restype = ctypes.c_int
    lib.dds_sched_cells.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_int]
    lib.dds_sched_pin_route.restype = ctypes.c_int
    lib.dds_sched_pin_route.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.dds_sched_pin_lanes.restype = ctypes.c_int
    lib.dds_sched_pin_lanes.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
    lib.dds_set_async_width.restype = ctypes.c_int
    lib.dds_set_async_width.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dds_async_width.restype = ctypes.c_int
    lib.dds_async_width.argtypes = [ctypes.c_void_p]
    lib.dds_tenant_set_quota.restype = ctypes.c_int
    lib.dds_tenant_set_quota.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         _i64, _i64]
    lib.dds_tenant_set_share.restype = ctypes.c_int
    lib.dds_tenant_set_share.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int]
    lib.dds_tenant_set_lane_budget.restype = ctypes.c_int
    lib.dds_tenant_set_lane_budget.argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p,
                                               ctypes.c_int]
    lib.dds_tenant_names.restype = ctypes.c_int
    lib.dds_tenant_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.dds_tenant_stats.restype = ctypes.c_int
    lib.dds_tenant_stats.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     _i64p]
    lib.dds_snapshot_acquire.restype = _i64
    lib.dds_snapshot_acquire.argtypes = [ctypes.c_void_p,
                                         ctypes.c_char_p]
    lib.dds_snapshot_release.restype = ctypes.c_int
    lib.dds_snapshot_release.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_snapshot_stats.restype = ctypes.c_int
    lib.dds_snapshot_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_replication.restype = ctypes.c_int
    lib.dds_replication.argtypes = [ctypes.c_void_p]
    lib.dds_replicate.restype = ctypes.c_int
    lib.dds_replicate.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dds_refresh_mirrors.restype = ctypes.c_int
    lib.dds_refresh_mirrors.argtypes = [ctypes.c_void_p]
    lib.dds_replica_set.restype = ctypes.c_int
    lib.dds_replica_set.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_int]
    lib.dds_health_state.restype = ctypes.c_int
    lib.dds_health_state.argtypes = [ctypes.c_void_p, _i64p, ctypes.c_int]
    lib.dds_heartbeat_configure.restype = ctypes.c_int
    lib.dds_heartbeat_configure.argtypes = [ctypes.c_void_p,
                                            ctypes.c_long, ctypes.c_int]
    lib.dds_mark_suspect.restype = ctypes.c_int
    lib.dds_mark_suspect.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.dds_failover_stats.restype = ctypes.c_int
    lib.dds_failover_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_fault_configure.restype = ctypes.c_int
    lib.dds_fault_configure.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_char_p]
    lib.dds_fault_stats.restype = ctypes.c_int
    lib.dds_fault_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_integrity_configure.restype = ctypes.c_int
    lib.dds_integrity_configure.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_long]
    lib.dds_integrity_stats.restype = ctypes.c_int
    lib.dds_integrity_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_integrity_sums.restype = ctypes.c_int
    lib.dds_integrity_sums.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       _i64, _i64,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       _i64p]
    lib.dds_integrity_scrub.restype = ctypes.c_int
    lib.dds_integrity_scrub.argtypes = [ctypes.c_void_p]
    lib.dds_tier_configure.restype = ctypes.c_int
    lib.dds_tier_configure.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_set_var_tier.restype = ctypes.c_int
    lib.dds_set_var_tier.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.dds_var_tier.restype = ctypes.c_int
    lib.dds_var_tier.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dds_set_tier_placement.restype = ctypes.c_int
    lib.dds_set_tier_placement.argtypes = [ctypes.c_void_p,
                                           ctypes.c_char_p, ctypes.c_int]
    lib.dds_cache_prefetch.restype = _i64
    lib.dds_cache_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       _i64p, _i64, _i64, ctypes.c_char_p]
    lib.dds_cache_evict.restype = ctypes.c_int
    lib.dds_cache_evict.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_tiering_stats.restype = ctypes.c_int
    lib.dds_tiering_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_create_uring.restype = ctypes.c_void_p
    lib.dds_create_uring.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    lib.dds_uring_probe.restype = ctypes.c_int
    lib.dds_uring_probe.argtypes = [_i64p]
    lib.dds_uring_probe_reason.restype = ctypes.c_int
    lib.dds_uring_probe_reason.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.dds_uring_state.restype = ctypes.c_int
    lib.dds_uring_state.argtypes = [ctypes.c_void_p]
    lib.dds_uring_reason.restype = ctypes.c_int
    lib.dds_uring_reason.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.dds_uring_stats.restype = ctypes.c_int
    lib.dds_uring_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_cold_direct_stats.restype = ctypes.c_int
    lib.dds_cold_direct_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_set_var_file.restype = ctypes.c_int
    lib.dds_set_var_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    lib.dds_req_send_stats.restype = ctypes.c_int
    lib.dds_req_send_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_metrics_configure.restype = ctypes.c_int
    lib.dds_metrics_configure.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dds_metrics_enabled.restype = ctypes.c_int
    lib.dds_metrics_enabled.argtypes = [ctypes.c_void_p]
    lib.dds_metrics_reset.restype = ctypes.c_int
    lib.dds_metrics_reset.argtypes = [ctypes.c_void_p]
    lib.dds_metrics_snapshot.restype = _i64
    lib.dds_metrics_snapshot.argtypes = [ctypes.c_void_p,
                                         ctypes.c_void_p, _i64]
    lib.dds_metrics_pull.restype = _i64
    lib.dds_metrics_pull.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p, _i64]
    lib.dds_metrics_stats.restype = ctypes.c_int
    lib.dds_metrics_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_metrics_tenants.restype = ctypes.c_int
    lib.dds_metrics_tenants.argtypes = [ctypes.c_void_p,
                                        ctypes.c_char_p, ctypes.c_int]
    lib.dds_metrics_record.restype = ctypes.c_int
    lib.dds_metrics_record.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_char_p, _i64, _i64]
    lib.dds_slo_configure.restype = ctypes.c_int
    lib.dds_slo_configure.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.dds_slo_evaluate.restype = _i64
    lib.dds_slo_evaluate.argtypes = [ctypes.c_void_p, _i64p,
                                     ctypes.c_int]
    lib.dds_slo_stats.restype = ctypes.c_int
    lib.dds_slo_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_gateway_configure.restype = ctypes.c_int
    lib.dds_gateway_configure.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_long, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_long]
    lib.dds_gateway_attach.restype = _i64
    lib.dds_gateway_attach.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int,
                                       _i64]
    lib.dds_gateway_renew.restype = ctypes.c_int
    lib.dds_gateway_renew.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      _i64]
    lib.dds_gateway_detach.restype = ctypes.c_int
    lib.dds_gateway_detach.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       _i64]
    lib.dds_gateway_drain.restype = ctypes.c_int
    lib.dds_gateway_drain.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.dds_gateway_reap.restype = ctypes.c_int
    lib.dds_gateway_reap.argtypes = [ctypes.c_void_p]
    lib.dds_gateway_stats.restype = ctypes.c_int
    lib.dds_gateway_stats.argtypes = [ctypes.c_void_p, _i64p]
    lib.dds_trace_configure.restype = ctypes.c_int
    lib.dds_trace_configure.argtypes = [ctypes.c_int, ctypes.c_long]
    lib.dds_trace_enabled.restype = ctypes.c_int
    lib.dds_trace_enabled.argtypes = []
    lib.dds_trace_reset.restype = ctypes.c_int
    lib.dds_trace_reset.argtypes = []
    lib.dds_trace_emit.restype = ctypes.c_int
    lib.dds_trace_emit.argtypes = [ctypes.c_uint32, ctypes.c_uint64,
                                   ctypes.c_int, _i64, _i64, _i64]
    lib.dds_trace_new_span.restype = ctypes.c_uint64
    lib.dds_trace_new_span.argtypes = [ctypes.c_int]
    lib.dds_trace_flight.restype = ctypes.c_int
    lib.dds_trace_flight.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dds_trace_dump.restype = _i64
    lib.dds_trace_dump.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_trace_flight_dump.restype = _i64
    lib.dds_trace_flight_dump.argtypes = [ctypes.c_void_p, _i64]
    lib.dds_trace_stats.restype = ctypes.c_int
    lib.dds_trace_stats.argtypes = [_i64p]
    lib.dds_rank.restype = ctypes.c_int
    lib.dds_rank.argtypes = [ctypes.c_void_p]
    lib.dds_world.restype = ctypes.c_int
    lib.dds_world.argtypes = [ctypes.c_void_p]
    lib.dds_destroy.restype = None
    lib.dds_destroy.argtypes = [ctypes.c_void_p]
    lib.dds_release_local_group.restype = None
    lib.dds_release_local_group.argtypes = [ctypes.c_char_p]
    lib.dds_error_string.restype = ctypes.c_char_p
    lib.dds_error_string.argtypes = [ctypes.c_int]
    lib.dds_owner_of.restype = ctypes.c_int
    lib.dds_owner_of.argtypes = [_i64p, ctypes.c_int, _i64]
    _lib = lib
    return lib


# Error codes tested by the Python-side classification (mirrors
# dds::ErrorCode; see native/store.h).
ERR_INVALID_ARG = -1  # bad name / shape / range / tier
ERR_NOT_FOUND = -2   # unknown variable / expired gateway lease token
ERR_TRANSPORT = -6   # transient-class transport failure
ERR_PEER_LOST = -10  # transient-retry budget exhausted: owner presumed
#                      dead — fatal, invoke elastic.recover
ERR_QUOTA = -11      # tenant byte/var budget exhausted at registration:
#                      admission refused — nothing died, free variables
#                      or raise the quota (distinct from ERR_PEER_LOST)
ERR_CORRUPT = -12    # data integrity failure (DDSTORE_VERIFY=1): the
#                      delivered bytes disagree with the owner's
#                      published checksums at a stable content version
#                      on every readable holder — non-fatal like
#                      ERR_QUOTA (nothing died; the store's bytes may
#                      be fine and only one holder rotten — inspect
#                      integrity_stats()["last_corrupt_peer"])
ERR_ADMISSION = -13  # serving-gateway admission refusal: over-share
#                      tenant deferred past its window (or the rank is
#                      draining) — non-fatal, defer-not-peer-lost; the
#                      gateway's last_retry_after_ms stat carries the
#                      back-off hint (seeded-jitter retry, then give up)


ERR_CLOSED = -64     # the binding's own: a call on a NativeStore whose
#                      close() has begun (no native code; nothing died)


class DDStoreError(RuntimeError):
    """Raised when the native core reports an error (maps the C error codes
    the way the reference surfaces C++ throws through Cython ``except +``,
    pyddstore.pyx:44-50), or a call on a closed store (:data:`ERR_CLOSED`)."""

    def __init__(self, code: int, context: str = ""):
        self.code = code
        msg = "store is closed" if code == ERR_CLOSED else \
            _load().dds_error_string(code).decode()
        super().__init__(f"{context}: {msg}" if context else msg)


def _check(code: int, context: str = "") -> None:
    if code != 0:
        raise DDStoreError(code, context)


def owner_of(cum: Sequence[int], row: int) -> int:
    """Owner rank of global row `row` given cumulative row counts."""
    arr = np.ascontiguousarray(cum, dtype=np.int64)
    return _load().dds_owner_of(arr.ctypes.data_as(_i64p), len(arr), row)


def fault_configure(spec: str, seed: int = 0,
                    ranks: Optional[Sequence[int]] = None) -> None:
    """(Re)configure the process-global deterministic fault injector —
    the runtime equivalent of ``DDSTORE_FAULT_SPEC``/``_SEED``/``_RANKS``.

    ``spec`` is ``kind:probability[:param_ms]`` entries joined by commas
    (data kinds: ``reset``, ``trunc``, ``delay``, ``stall``,
    ``corrupt``; control-plane kinds: ``ctrl-reset``, ``ctrl-delay``,
    ``ctrl-stall`` — these target the request/response control ops and
    draw from their OWN seeded counter domain, so data-plane schedules
    are bit-identical with the ctrl arm present or absent); an empty
    spec disables injection. ``ranks`` restricts injection to ops
    SERVED by those ranks (per-peer fault schedules in shared-process
    tests). Resets every injector counter including both draw
    counters, so the same ``(spec, seed)`` replays the same fault
    schedule."""
    ranks_csv = ",".join(str(int(r)) for r in ranks) if ranks else ""
    _check(_load().dds_fault_configure(spec.encode(), int(seed),
                                       ranks_csv.encode()),
           f"fault_configure({spec!r})")


#: Default transient-retry deadline seconds when DDSTORE_OP_DEADLINE_S
#: is unset — keep in sync with the native RetryPolicy default in
#: fault.cc (the readahead degraded path derives its shared-budget math
#: from this; drift would silently hand refetches the wrong base).
DEFAULT_OP_DEADLINE_S = 300.0


# -- ddtrace: event-ring tracing + flight recorder ---------------------------
#
# Process-global like the fault injector (rings belong to THREADS, and a
# ThreadGroup test's in-process "ranks" share one trace — every event
# carries its emitting rank). All decode tables here mirror native
# enums/layouts in native/trace.h; drift breaks the dump format.

#: numpy layout of one dumped trace event (keep in sync with
#: trace.h `Event` — 48 packed bytes).
TRACE_EVENT_DTYPE = np.dtype([
    ("t_ns", "<u8"), ("span", "<u8"), ("type", "<u2"), ("tid", "<u2"),
    ("rank", "<i4"), ("a", "<i8"), ("b", "<i8"), ("c", "<i8")])

#: event-type decode table (trace.h EventType).
TRACE_TYPES = {
    1: "op_begin", 2: "op_end", 3: "retry", 4: "backoff",
    5: "lane_dial", 6: "lane_close", 7: "serve_begin", 8: "serve_end",
    9: "cma_read", 10: "window_issue", 11: "window_ready",
    12: "window_stall", 13: "plan_replan", 14: "plan_applied",
    15: "suspect", 16: "suspect_clear", 17: "quota_reject",
    18: "lane_budget_rotate", 19: "flight", 20: "failover",
    21: "verify_fail", 22: "scrub", 23: "barrier", 24: "barrier_done",
    25: "barrier_abort", 26: "cache_fill", 27: "cache_hit",
    28: "cache_evict", 29: "slo_breach", 30: "gw_session",
    31: "gw_shed",
}
#: name -> code view of :data:`TRACE_TYPES` (Python-side emitters).
TRACE_TYPE_CODES = {v: k for k, v in TRACE_TYPES.items()}

#: op classes carried in op_begin/op_end `a` (trace.h OpClass).
TRACE_OP_CLASSES = {0: "get", 1: "get_batch", 2: "read_runs",
                    3: "async_batch"}

#: flight-recorder trigger codes (trace.h FlightReason).
TRACE_FLIGHT_REASONS = {1: "peer_lost", 2: "quota", 3: "window_giveup",
                        4: "suspect", 5: "manual", 6: "corrupt",
                        7: "barrier_abort", 8: "slo_breach",
                        9: "shed_storm"}

#: dict keys of :func:`trace_stats`, in native layout order (keep in
#: sync with capi dds_trace_stats / trace::Stats).
#: ``captured``/``dropped``/``flight_dumps``/``spans`` are monotone
#: since process start; the rest are gauges.
TRACE_STAT_KEYS = ("enabled", "ring_events", "threads", "capacity",
                   "live", "captured", "dropped", "flight_events",
                   "flight_dumps", "spans")


# -- ddmetrics: always-on latency/bytes histograms + SLO monitor --------------
#
# Per-STORE (unlike the process-global trace rings): a ThreadGroup's
# in-process ranks keep separate latency surfaces, and the cross-rank
# pull (kOpMetrics) merges them into one cluster view. All layouts
# mirror native/metrics_hist.h; drift breaks the snapshot format.

#: log2 bucket count of each histogram (metrics_hist.h kBuckets).
METRICS_BUCKETS = 44

#: numpy layout of one snapshot cell (keep in sync with
#: metrics_hist.h `CellRecord` — packed little-endian).
METRICS_CELL_DTYPE = np.dtype([
    ("cls", "<i4"), ("route", "<i4"), ("peer", "<i4"),
    ("reserved", "<i4"), ("tenant", "S48"),
    ("count", "<u8"), ("lat_sum_ns", "<u8"),
    ("lat", "<u8", (METRICS_BUCKETS,)),
    ("bytes_sum", "<u8"),
    ("bytes", "<u8", (METRICS_BUCKETS,))])

#: route decode table (metrics_hist.h Route — ordered by the
#: span_latency attribution precedence: uring > cma > tcp > local).
METRICS_ROUTES = {0: "local", 1: "tcp", 2: "cma", 3: "uring"}
#: name -> code view (Python-side recorders / tests).
METRICS_ROUTE_CODES = {v: k for k, v in METRICS_ROUTES.items()}

#: dict keys of ``NativeStore.metrics_stats`` in native layout order
#: (keep in sync with capi dds_metrics_stats).
METRICS_STAT_KEYS = ("enabled", "cells", "cells_cap", "dropped_cells",
                     "tenants", "tenant_overflow", "ops_recorded")

#: dict keys of ``NativeStore.slo_stats`` in native layout order (keep
#: in sync with capi dds_slo_stats). ``evaluations``/``breaches`` are
#: monotone; the rest are gauges.
SLO_STAT_KEYS = ("rules", "evaluations", "breaches", "window_ms",
                 "last_breach_tenant_slot")
#: the gauge subset of :data:`SLO_STAT_KEYS` (never delta'd).
SLO_GAUGE_KEYS = ("rules", "window_ms", "last_breach_tenant_slot")

#: dict keys of ``NativeStore.gateway_stats`` in native layout order
#: (keep in sync with capi dds_gateway_stats / gw::Gateway::Stats).
#: attaches..rejected and drain_sheds are monotone; the rest gauges.
GATEWAY_STAT_KEYS = ("enabled", "sessions", "attaches", "detaches",
                     "expired", "renewals", "admitted", "deferred",
                     "rejected", "drain_sheds", "draining", "inflight",
                     "deferred_now", "last_retry_after_ms")
#: the gauge subset of :data:`GATEWAY_STAT_KEYS` (never delta'd).
GATEWAY_GAUGE_KEYS = ("enabled", "sessions", "draining", "inflight",
                      "deferred_now", "last_retry_after_ms")


def trace_configure(enabled: int, ring_events: int = -1) -> None:
    """Flip tracing on/off at runtime (``enabled`` 0/1; -1 keeps) and
    optionally set the per-thread ring capacity for rings allocated
    from now on (existing threads keep their rings). The load-time
    equivalents are ``DDSTORE_TRACE`` / ``DDSTORE_TRACE_RING``."""
    _check(_load().dds_trace_configure(int(enabled), int(ring_events)),
           "trace_configure")


def trace_enabled() -> bool:
    """One native relaxed load: is tracing recording right now?"""
    return bool(_load().dds_trace_enabled())


def trace_reset() -> None:
    """Drop every recorded event (rings trimmed, flight buffer
    cleared); the monotone totals in :func:`trace_stats` keep
    counting. Test/bench isolation hook."""
    _check(_load().dds_trace_reset(), "trace_reset")


def trace_emit(type_, span: int = 0, rank: int = -1, a: int = 0,
               b: int = 0, c: int = 0) -> None:
    """Append one event to THIS thread's ring (no-op while tracing is
    off). ``type_`` is a :data:`TRACE_TYPES` code or name — the hook
    Python-side emitters (readahead windows, scheduler replans) use."""
    code = TRACE_TYPE_CODES.get(type_, type_) \
        if isinstance(type_, str) else int(type_)
    _load().dds_trace_emit(int(code), int(span), int(rank), int(a),
                           int(b), int(c))


def trace_new_span(rank: int = -1) -> int:
    """Mint a fresh span id for a Python-side logical op."""
    return int(_load().dds_trace_new_span(int(rank)))


def trace_flight(reason, rank: int = -1) -> None:
    """Trigger the flight recorder manually (``reason`` a
    :data:`TRACE_FLIGHT_REASONS` code or name) — the readahead window
    give-up path calls this."""
    codes = {v: k for k, v in TRACE_FLIGHT_REASONS.items()}
    code = codes.get(reason, reason) if isinstance(reason, str) \
        else int(reason)
    _check(_load().dds_trace_flight(int(code), int(rank)),
           "trace_flight")


def trace_stats() -> dict:
    """Trace counters (:data:`TRACE_STAT_KEYS`): rings/threads/live
    occupancy gauges plus the monotone captured/dropped/flight/span
    totals."""
    arr = (ctypes.c_int64 * 12)()
    _check(_load().dds_trace_stats(arr), "trace_stats")
    return dict(zip(TRACE_STAT_KEYS, list(arr)[:len(TRACE_STAT_KEYS)]))


def _trace_dump_call(fn) -> np.ndarray:
    need = int(fn(None, 0))
    if need <= 0:
        return np.empty(0, dtype=TRACE_EVENT_DTYPE)
    buf = ctypes.create_string_buffer(need)
    n = int(fn(buf, need))
    events = np.frombuffer(buf.raw[:n], dtype=TRACE_EVENT_DTYPE).copy()
    # Chronological merge across the per-thread rings.
    return events[np.argsort(events["t_ns"], kind="stable")]


def trace_dump() -> np.ndarray:
    """Every live ring event of this process as a structured array
    (:data:`TRACE_EVENT_DTYPE`), time-sorted across threads. Bounded by
    the rings' capacity; empty when tracing never ran."""
    return _trace_dump_call(_load().dds_trace_dump)


def trace_flight_dump() -> np.ndarray:
    """The LAST flight-recorder snapshot (same format as
    :func:`trace_dump`, ending in its ``flight`` marker event)."""
    return _trace_dump_call(_load().dds_trace_flight_dump)


#: dict keys of :meth:`NativeStore.lane_state`, in native layout order.
#: ``active_lanes``/``parked``/``best_bw_bytes_per_s`` describe the
#: bulk-stripe tuner (the headline); the scatter class (many-small-op
#: dealing) has its own tuner with its own park.
LANE_STATE_KEYS = ("max_lanes", "active_lanes", "parked", "autotune",
                   "samples", "best_bw_bytes_per_s",
                   "scatter_active_lanes", "scatter_parked")


#: column names of one :meth:`NativeStore.sched_cells` row, in native
#: layout order (keep in sync with TcpTransport::SchedCells). ``source``
#: 0 = CMA/TCP router cell, 1 = lane-tuner level cell; ``cls`` 0 = bulk,
#: 1 = scatter; ``knob`` is the route (0 = cma, 1 = tcp) or the lane
#: count the cell measures.
SCHED_CELL_COLS = ("source", "cls", "knob", "ewma_bps", "n")


#: dict keys of :meth:`NativeStore.failover_stats`, in native layout
#: order (keep in sync with capi dds_failover_stats /
#: Store::FailoverCounters). ``replication``, ``hb_active`` and
#: ``suspected_now`` are GAUGES; everything else is monotone since
#: store creation (PipelineMetrics diffs those per epoch).
FAILOVER_STAT_KEYS = (
    "replication", "failover_reads", "failover_runs", "failover_bytes",
    "suspect_skips", "replica_giveups", "mirror_fills",
    "mirror_refresh_skipped", "mirror_bytes", "hb_pings", "hb_failures",
    "hb_suspects_raised", "hb_active", "suspected_now",
)

#: the gauge subset of :data:`FAILOVER_STAT_KEYS` (never delta'd).
FAILOVER_GAUGE_KEYS = ("replication", "hb_active", "suspected_now")


#: dict keys of :meth:`NativeStore.tenant_stats`, in native layout
#: order (keep in sync with capi dds_tenant_stats /
#: Store::TenantCounters). ``quota_bytes``/``quota_vars``/``bytes``/
#: ``vars``/``snapshot_pins``/``share`` are GAUGES; the rest is
#: monotone since store creation (PipelineMetrics diffs those per
#: epoch into ``summary()["tenants"]``).
TENANT_STAT_KEYS = (
    "quota_bytes", "quota_vars", "bytes", "vars", "quota_rejections",
    "read_bytes", "reads", "served_bytes", "served_reads",
    "async_admitted", "async_deferred", "snapshot_pins", "share",
)

#: the gauge subset of :data:`TENANT_STAT_KEYS` (never delta'd).
TENANT_GAUGE_KEYS = ("quota_bytes", "quota_vars", "bytes", "vars",
                     "snapshot_pins", "share")


#: dict keys of :meth:`NativeStore.fault_stats`, in native layout order.
FAULT_STAT_KEYS = (
    "fault_checks", "injected_reset", "injected_trunc", "injected_delay",
    "injected_stall", "injected_delay_ms",
    "retry_transient", "retry_attempts", "retry_reconnects",
    "retry_backoff_ms", "retry_giveups", "retry_fatal", "last_error_peer",
    "injected_corrupt", "ctrl_checks", "ctrl_injected",
)


#: dict keys of :meth:`NativeStore.integrity_stats`, in native layout
#: order (keep in sync with capi dds_integrity_stats /
#: Store::IntegrityStats). ``verify_mode``/``sums_tables``/
#: ``last_corrupt_peer`` are GAUGES; everything else is monotone since
#: store creation (PipelineMetrics diffs those per epoch into
#: ``summary()["integrity"]``).
INTEGRITY_STAT_KEYS = (
    "verify_mode", "sums_tables", "sums_computed", "sums_rows",
    "sums_served", "verified_reads", "verified_bytes",
    "verify_mismatches", "verify_seq_retries", "verify_primary_retries",
    "verify_failovers", "corrupt_errors", "scrub_rows",
    "scrub_divergent", "scrub_repaired", "last_corrupt_peer",
)

#: the gauge subset of :data:`INTEGRITY_STAT_KEYS` (never delta'd).
INTEGRITY_GAUGE_KEYS = ("verify_mode", "sums_tables", "last_corrupt_peer")


#: dict keys of :meth:`NativeStore.tiering_stats`, in native layout
#: order (keep in sync with capi dds_tiering_stats /
#: Store::TieringStats). The first five are GAUGES (cache budget and
#: occupancy, cold-tier registrations); everything else is monotone
#: since store creation (PipelineMetrics diffs those per epoch into
#: ``summary()["tiering"]``).
TIERING_STAT_KEYS = (
    "cache_max_bytes", "cache_bytes", "cache_entries", "cold_vars",
    "cold_bytes", "cache_hits", "cache_hit_bytes", "cache_misses",
    "cache_miss_bytes", "cache_fills", "cache_fill_bytes",
    "cache_fill_failures", "cache_evictions", "cache_evicted_bytes",
    "cache_over_budget", "cache_prefetches",
)

#: the gauge subset of :data:`TIERING_STAT_KEYS` (never delta'd).
TIERING_GAUGE_KEYS = ("cache_max_bytes", "cache_bytes", "cache_entries",
                      "cold_vars", "cold_bytes")


#: dict keys of :func:`uring_probe` in native layout order (keep in
#: sync with capi dds_uring_probe). ``features`` is the raw
#: IORING_FEAT_* bitmask from io_uring_setup; the op_* flags come from
#: IORING_REGISTER_PROBE.
URING_PROBE_KEYS = ("supported", "features", "op_send", "op_recv",
                    "op_sendmsg", "op_recvmsg", "op_read",
                    "op_read_fixed", "ext_arg", "reserved")

#: dict keys of :meth:`NativeStore.uring_stats` in native layout order
#: (keep in sync with capi dds_uring_stats /
#: UringTransport::UringCounters). ``engaged`` is a gauge; the rest are
#: monotone. A healthy engaged run shows ``enters`` far below
#: ``frames`` — that ratio IS the syscall batching win.
URING_STAT_KEYS = ("engaged", "bursts", "enters", "sqes", "frames",
                   "fallbacks", "ring_errors")

#: the gauge subset of :data:`URING_STAT_KEYS` (never delta'd).
URING_GAUGE_KEYS = ("engaged",)

#: dict keys of :meth:`NativeStore.cold_direct_stats` in native layout
#: order (keep in sync with capi dds_cold_direct_stats /
#: ColdDirectReader::Stats). ``files``/``regbuf``/``ring_ok`` are
#: gauges; the rest monotone.
COLD_DIRECT_STAT_KEYS = ("files", "reads", "bytes", "fallbacks",
                         "regbuf", "ring_ok")

#: the gauge subset of :data:`COLD_DIRECT_STAT_KEYS` (never delta'd).
COLD_DIRECT_GAUGE_KEYS = ("files", "regbuf", "ring_ok")


def uring_probe() -> dict:
    """Process-wide io_uring capability verdict, independent of any
    store (:data:`URING_PROBE_KEYS` plus a human ``reason`` string —
    "ok", or why the kernel refused). Cached after the first call; the
    diag module and the bench record it so a TCP-fallback run is
    diagnosable from its artifacts alone."""
    lib = _load()
    arr = (ctypes.c_int64 * 10)()
    _check(lib.dds_uring_probe(arr), "uring_probe")
    out = dict(zip(URING_PROBE_KEYS, list(arr)))
    del out["reserved"]
    buf = ctypes.create_string_buffer(256)
    lib.dds_uring_probe_reason(buf, 256)
    out["reason"] = buf.value.decode(errors="replace")
    return out


def _as_i64p(arr: np.ndarray):
    return arr.ctypes.data_as(_i64p)


class NativeStore:
    """Thin, byte-oriented wrapper over one native store instance.

    Every call on the handle goes through :meth:`_call`, which counts it
    in flight from reading the handle until the foreign call returns.
    :meth:`close` waits until no call is in flight before it frees the
    native store, and a call that starts once :meth:`close` has begun
    raises :class:`DDStoreError` (:data:`ERR_CLOSED`) without touching
    the handle. ctypes releases the GIL inside each call, so without this
    another thread's ``close`` could free the store under a read."""

    def __init__(self, handle: int, local_gid: Optional[str] = None):
        if not handle:
            raise RuntimeError("native store creation failed")
        self._h = handle
        self._local_gid = local_gid
        self._lib = _load()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)  # close() waits on it
        self._in_flight = 0
        self._closing = False

    def _call(self, fn, *args):
        """``fn(handle, *args)`` counted in flight; raises
        :data:`ERR_CLOSED` once :meth:`close` has begun."""
        with self._lock:
            if self._closing:
                raise DDStoreError(ERR_CLOSED, fn.__name__)
            self._in_flight += 1
            h = self._h
        try:
            return fn(h, *args)
        finally:
            with self._lock:
                self._in_flight -= 1
                if self._closing and not self._in_flight:
                    self._idle.notify_all()

    # -- constructors ------------------------------------------------------

    @classmethod
    def create_local(cls, group_id: str, rank: int, world: int) -> "NativeStore":
        lib = _load()
        h = lib.dds_create_local(group_id.encode(), rank, world)
        return cls(h, local_gid=group_id)

    @classmethod
    def create_tcp(cls, rank: int, world: int, port: int = 0) -> "NativeStore":
        lib = _load()
        h = lib.dds_create_tcp(rank, world, port)
        return cls(h)

    @classmethod
    def create_uring(cls, rank: int, world: int,
                     port: int = 0) -> "NativeStore":
        """io_uring wire backend (``DDSTORE_TRANSPORT=uring``). A
        drop-in TcpTransport subclass: peers, lanes, faults, failover
        and the gateway all behave identically; only the per-lane wire
        loop batches a whole frame burst into one ``io_uring_enter``.
        Construction NEVER fails on an io_uring-less kernel — the
        handle serves through the inherited TCP path and
        :meth:`uring_state`/:meth:`uring_reason` export the verdict."""
        lib = _load()
        h = lib.dds_create_uring(rank, world, port)
        return cls(h)

    # -- transport wiring --------------------------------------------------

    @property
    def server_port(self) -> int:
        return self._call(self._lib.dds_server_port)

    def set_peers(self, hosts: Sequence[str], ports: Sequence[int]) -> None:
        """Each host entry may be a comma-separated per-NIC address list;
        the peer's connection pool spreads round-robin across them."""
        n = len(hosts)
        harr = (ctypes.c_char_p * n)(*[h.encode() for h in hosts])
        parr = (ctypes.c_int * n)(*ports)
        _check(self._call(self._lib.dds_set_peers, harr, parr, n), "set_peers")

    def set_ifaces(self, addrs: Sequence[str]) -> None:
        """Local per-NIC source addresses; outgoing pool connections bind
        to them round-robin (multi-NIC striping, DDSTORE_IFACES)."""
        _check(self._call(
            self._lib.dds_set_ifaces, ",".join(addrs).encode()), "set_ifaces")

    def update_peer(self, target: int, host: str, port: int) -> None:
        """Elastic recovery: re-point one peer at a relaunched
        replacement's endpoint (stale connections closed, CMA re-probed
        against the new pid)."""
        _check(self._call(
            self._lib.dds_update_peer,
            target, host.encode(), port), f"update_peer({target})")

    def routing_state(self) -> dict:
        """Adaptive routing snapshot for both traffic classes (bulk =
        single >=8 MiB reads; scatter = many-small-op batches): per-path
        EWMA bandwidths, decision/probe counts, crossovers, current
        preference — exported into bench extras so routing regressions
        are diagnosable from the BENCH json alone."""
        out = {}
        for cls, label in ((0, "bulk"), (1, "scatter")):
            cma = ctypes.c_double()
            tcp = ctypes.c_double()
            dec = ctypes.c_int64()
            cro = ctypes.c_int64()
            via = ctypes.c_int()
            cal = ctypes.c_int()
            _check(self._call(
                self._lib.dds_routing_state,
                cls, ctypes.byref(cma), ctypes.byref(tcp),
                ctypes.byref(dec), ctypes.byref(cro), ctypes.byref(via),
                ctypes.byref(cal)),
                "routing_state")
            out.update({f"cma_{label}_gbps": cma.value / 1e9,
                        f"tcp_{label}_gbps": tcp.value / 1e9,
                        f"{label}_decisions": dec.value,
                        f"{label}_crossovers": cro.value,
                        f"{label}_via_tcp": bool(via.value),
                        f"{label}_calibrated": bool(cal.value)})
        # Same-host Unix-lane dials: whether loopback peers actually took
        # the UDS fast lane or silently fell back to loopback TCP.
        out["uds_conns"] = self._call(self._lib.dds_uds_conns)
        return out

    def set_retry_deadline(self, seconds: float) -> None:
        """Override THIS store's transient-retry deadline
        (``DDSTORE_OP_DEADLINE_S``); ``<= 0`` restores the env/default.
        The degraded readahead path uses it to share ONE deadline
        budget across a window give-up and its per-batch refetch, so a
        permanently dead owner surfaces ``kErrPeerLost`` within ~1x the
        deadline instead of ~2x. Per-store: other stores in the process
        keep their full budgets; still advisory within this store —
        concurrent reads on it see the reduced budget while set, so
        callers must clear it in a ``finally``."""
        _check(self._call(self._lib.dds_set_retry_deadline, float(seconds)),
               "set_retry_deadline")

    def lane_state(self) -> dict:
        """Striped-lane autotuner snapshot (:data:`LANE_STATE_KEYS`):
        the configured pool size (``DDSTORE_TCP_LANES``), the lane count
        striped reads currently engage, whether the tuner has parked
        (per-lane throughput stopped scaling), and the best measured
        stripe bandwidth. ``{}`` for non-TCP backends."""
        arr = (ctypes.c_int64 * 8)()
        if self._call(self._lib.dds_lane_state, arr) != 0:
            return {}
        out = dict(zip(LANE_STATE_KEYS, list(arr)[:len(LANE_STATE_KEYS)]))
        for k in ("parked", "autotune", "scatter_parked"):
            out[k] = bool(out[k])
        return out

    def lane_bytes(self, target: int = -1) -> list:
        """Per-lane response bytes carried over TCP/UDS since store
        creation (``target >= 0``: that peer's lanes; ``-1``: summed
        across peers, lane-index-aligned). ``[]`` for non-TCP backends.
        Monotone; diff snapshots for per-epoch lane utilization — that
        is what ``PipelineMetrics`` does with its lane source."""
        cap = 64
        arr = (ctypes.c_int64 * cap)()
        n = self._call(self._lib.dds_lane_bytes, int(target), arr, cap)
        if n < 0:
            return []
        return list(arr)[:n]

    def sched_cells(self) -> list:
        """Warm-window substrate snapshot for the cost-model scheduler:
        a list of dicts keyed by :data:`SCHED_CELL_COLS` — every
        router/lane-tuner measurement cell's EWMA bytes/s and clean
        sample count. ``[]`` for non-TCP backends (nothing to plan
        against; the planner then leaves the transport knobs alone)."""
        cap = 64
        arr = (ctypes.c_double * (cap * 5))()
        n = self._call(self._lib.dds_sched_cells, arr, cap)
        if n < 0:
            return []
        return [dict(zip(SCHED_CELL_COLS, arr[i * 5:(i + 1) * 5]))
                for i in range(n)]

    def sched_pin_route(self, cls: int, mode: int) -> None:
        """Planner route pin for traffic class ``cls`` (0 = bulk, 1 =
        scatter): ``mode`` 0 = CMA, 1 = TCP, -1 = release to the
        adaptive router. Ranks below the user env pins
        (``DDSTORE_CMA_BULK``/``SCATTER``); released by a peer update."""
        _check(self._call(self._lib.dds_sched_pin_route, int(cls), int(mode)),
               f"sched_pin_route({cls}, {mode})")

    def sched_pin_lanes(self, cls: int, lanes: int) -> None:
        """Planner lane-width pin for traffic class ``cls``: ``lanes``
        >= 1 pins the stripe width (clamped to the pool size), -1
        releases to the lane autotuner."""
        _check(self._call(self._lib.dds_sched_pin_lanes, int(cls),
                          int(lanes)),
               f"sched_pin_lanes({cls}, {lanes})")

    def set_async_width(self, n: int) -> None:
        """Async admission width (concurrently RUNNING async batched
        reads): ``n`` >= 1 overrides, <= 0 restores the
        ``DDSTORE_ASYNC_THREADS`` / core-ladder default. Excess issues
        queue and start as running reads complete — the ticket contract
        is unchanged."""
        _check(self._call(self._lib.dds_set_async_width, int(n)),
               f"set_async_width({n})")

    @property
    def async_width(self) -> int:
        """The admission width currently in force (override, env, or
        the 4/2/1 core-ladder default)."""
        return int(self._call(self._lib.dds_async_width))

    # -- tenant namespaces / quotas / snapshot epochs ----------------------

    def tenant_set_quota(self, tenant: str, max_bytes: int,
                         max_vars: int = -1) -> None:
        """Byte/var budget for ``tenant`` (< 0 = unlimited). Checked
        atomically at add/init registration; over-budget registrations
        raise :data:`ERR_QUOTA` — a distinct, non-fatal class."""
        _check(self._call(
            self._lib.dds_tenant_set_quota,
            tenant.encode(), int(max_bytes), int(max_vars)),
            f"tenant_set_quota({tenant})")

    def tenant_set_share(self, tenant: str, share: int) -> None:
        """Async-admission weight (>= 1): with any share configured,
        ``tenant`` runs at most ``max(1, width * share / total)``
        concurrent async batched reads; excess defers and admits as
        slots free (ticket contract unchanged)."""
        _check(self._call(
            self._lib.dds_tenant_set_share, tenant.encode(), int(share)),
            f"tenant_set_share({tenant})")

    def tenant_set_lane_budget(self, tenant: str, lanes: int) -> None:
        """QoS lane budget: striped reads of ``tenant``'s variables
        engage at most ``lanes`` transport lanes (<= 0 clears). No-op
        on non-TCP backends."""
        _check(self._call(
            self._lib.dds_tenant_set_lane_budget, tenant.encode(), int(lanes)),
            f"tenant_set_lane_budget({tenant})")

    def tenant_names(self) -> list:
        """Every tenant the store has seen (config or traffic). A
        leading separator marks the DEFAULT tenant "" — a CSV of plain
        labels cannot otherwise carry it."""
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        n = self._call(self._lib.dds_tenant_names, buf, cap)
        if n <= 0:
            return []
        raw = buf.value.decode()
        names = [""] if raw.startswith(",") else []
        return names + [t for t in raw.split(",") if t]

    def tenant_stats(self, tenant: str) -> dict:
        """Ledger snapshot for one tenant (:data:`TENANT_STAT_KEYS`)."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_tenant_stats, tenant.encode(), arr),
               f"tenant_stats({tenant})")
        return dict(zip(TENANT_STAT_KEYS,
                        list(arr)[:len(TENANT_STAT_KEYS)]))

    def snapshot_acquire(self, tenant: str = "") -> int:
        """Pin the store-wide current shard versions; returns the
        snapshot id the reader's scoped names carry. All-or-nothing: a
        peer that cannot be pinned fails the acquire (pins already
        placed are rolled back)."""
        sid = self._call(self._lib.dds_snapshot_acquire, tenant.encode())
        if sid <= 0:
            raise DDStoreError(int(sid), "snapshot_acquire")
        return int(sid)

    def snapshot_release(self, snap_id: int) -> None:
        """Release a snapshot everywhere; kept versions whose last pin
        this was are reclaimed. Idempotent."""
        _check(self._call(self._lib.dds_snapshot_release, int(snap_id)),
               f"snapshot_release({snap_id})")

    def snapshot_stats(self) -> dict:
        """This rank's snapshot gauges: active pins, kept shard
        versions and their RAM cost, plus the monotone count of pins
        reclaimed by the stale-pin reaper (TTL / dead owner)."""
        arr = (ctypes.c_int64 * 4)()
        _check(self._call(self._lib.dds_snapshot_stats, arr),
               "snapshot_stats")
        return {"active_snapshots": int(arr[0]),
                "kept_versions": int(arr[1]),
                "kept_bytes": int(arr[2]),
                "reclaimed_pins": int(arr[3])}

    # -- serving gateway ---------------------------------------------------

    def gateway_configure(self, enabled: int = -1, lease_ms: int = -1,
                          defer_ms: int = -1, queue_cap: int = -1,
                          admit_margin_pct: int = -1,
                          lane_share: int = -1,
                          pin_ttl_ms: int = -1) -> None:
        """Runtime gateway (re)configuration; -1 keeps each field.
        ``enabled=1`` clears a previous drain and (re)arms the lease
        reaper; ``pin_ttl_ms`` arms stranded-pin reclaim even with the
        gateway off. Load-time knobs: ``DDSTORE_GATEWAY`` /
        ``DDSTORE_GW_*`` / ``DDSTORE_SNAP_PIN_TTL_MS``."""
        _check(self._call(
            self._lib.dds_gateway_configure,
            int(enabled), int(lease_ms), int(defer_ms),
            int(queue_cap), int(admit_margin_pct), int(lane_share),
            int(pin_ttl_ms)), "gateway_configure")

    def gateway_attach(self, target: int = -1, tenant: str = "",
                       with_snapshot: bool = False,
                       quota_bytes: int = 0) -> int:
        """Attach an ephemeral reader session on ``target``'s gateway
        (< 0 = this rank) and return the session token. The lease
        must be renewed at ~lease/3 or its pins/quota/lane share are
        reaped."""
        token = int(self._call(
            self._lib.dds_gateway_attach, int(target), tenant.encode(),
            1 if with_snapshot else 0, int(quota_bytes)))
        if token < 0:
            raise DDStoreError(token, f"gateway_attach({tenant!r})")
        return token

    def gateway_renew(self, token: int, target: int = -1) -> None:
        """Lease heartbeat; raises ``ERR_NOT_FOUND`` after expiry."""
        _check(self._call(self._lib.dds_gateway_renew, int(target),
                          int(token)),
               f"gateway_renew({token})")

    def gateway_detach(self, token: int, target: int = -1) -> None:
        """Graceful goodbye: releases the lease's snapshot pins, quota
        reservation and (last-of-tenant) lane share."""
        _check(self._call(self._lib.dds_gateway_detach, int(target),
                          int(token)),
               f"gateway_detach({token})")

    def gateway_drain(self, deadline_ms: int = 1000) -> bool:
        """Stop admitting, wait up to ``deadline_ms`` for in-flight
        reads, shed the rest with ``ERR_ADMISSION``. True when the
        gateway went quiet inside the deadline."""
        rc = int(self._call(self._lib.dds_gateway_drain, int(deadline_ms)))
        if rc == 0:
            return True
        if rc == ERR_TRANSPORT:
            return False
        raise DDStoreError(rc, "gateway_drain")

    def gateway_reap(self) -> int:
        """One synchronous lease/pin reap pass (the deterministic test
        hook for the background reaper). Returns reclaimed pin count."""
        rc = int(self._call(self._lib.dds_gateway_reap))
        if rc < 0:
            raise DDStoreError(rc, "gateway_reap")
        return rc

    def gateway_stats(self) -> dict:
        """Gateway counters (:data:`GATEWAY_STAT_KEYS`)."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_gateway_stats, arr),
               "gateway_stats")
        return dict(zip(GATEWAY_STAT_KEYS,
                        list(arr)[:len(GATEWAY_STAT_KEYS)]))

    # -- ddmetrics: live latency histograms + SLO monitor -----------------

    def metrics_configure(self, enabled: int) -> None:
        """Flip THIS store's histograms at runtime (0/1; -1 keeps).
        Load-time knob: ``DDSTORE_METRICS`` (default on)."""
        _check(self._call(self._lib.dds_metrics_configure, int(enabled)),
               "metrics_configure")

    def metrics_enabled(self) -> bool:
        return bool(self._call(self._lib.dds_metrics_enabled))

    def metrics_reset(self) -> None:
        """Zero every cell's counters (claimed keys stay interned)."""
        _check(self._call(self._lib.dds_metrics_reset), "metrics_reset")

    def _metrics_decode(self, fn, *args) -> np.ndarray:
        need = int(self._call(self._lib.dds_metrics_snapshot, None, 0))
        if need <= 0:
            return np.empty(0, dtype=METRICS_CELL_DTYPE)
        buf = ctypes.create_string_buffer(need)
        n = int(self._call(fn, *args, buf, need))
        if n < 0:
            raise DDStoreError(n, "metrics snapshot/pull")
        return np.frombuffer(buf.raw[:n],
                             dtype=METRICS_CELL_DTYPE).copy()

    def metrics_snapshot(self) -> np.ndarray:
        """This store's live histogram cells as a structured array
        (:data:`METRICS_CELL_DTYPE`): one row per (class, route, peer,
        reading-tenant) with log2 latency/bytes buckets."""
        return self._metrics_decode(self._lib.dds_metrics_snapshot)

    def metrics_pull(self, target: int) -> np.ndarray:
        """Pull ``target``'s cells over the control plane (kOpMetrics
        on the dedicated heartbeat connection; never a data lane).
        Raises ``DDStoreError(ERR_PEER_LOST)`` for a detector-
        suspected/dead peer — zero control budget burned, no giveup."""
        return self._metrics_decode(self._lib.dds_metrics_pull,
                                    int(target))

    def metrics_stats(self) -> dict:
        """Histogram registry counters (:data:`METRICS_STAT_KEYS`)."""
        arr = (ctypes.c_int64 * 8)()
        _check(self._call(self._lib.dds_metrics_stats, arr),
               "metrics_stats")
        return dict(zip(METRICS_STAT_KEYS,
                        list(arr)[:len(METRICS_STAT_KEYS)]))

    def metrics_tenants(self) -> list:
        """Interned reading-tenant labels in slot order (slot 0 is the
        default tenant ``""``)."""
        buf = ctypes.create_string_buffer(4096)
        n = self._call(self._lib.dds_metrics_tenants, buf, 4096)
        if n < 0:
            raise DDStoreError(n, "metrics_tenants")
        return buf.value.decode().split(",")

    def metrics_record(self, cls: int, route: int, peer: int,
                       tenant: str, lat_ns: int, nbytes: int) -> None:
        """Fold one synthetic op sample into the histograms (test /
        Python-side-op hook)."""
        _check(self._call(
            self._lib.dds_metrics_record,
            int(cls), int(route), int(peer), tenant.encode(),
            int(lat_ns), int(nbytes)), "metrics_record")

    def slo_configure(self, spec: str) -> None:
        """Replace the tenant latency objectives
        (``"t=p99:5ms,t2=p50:200us"``; a bare ``"p99:5ms"`` names the
        default tenant; empty clears). Baselines reset to the current
        histograms. Load-time knob: ``DDSTORE_TENANT_SLOS``."""
        _check(self._call(self._lib.dds_slo_configure, spec.encode()),
               f"slo_configure({spec!r})")

    def slo_evaluate(self) -> list:
        """Evaluate every objective over the histogram delta since the
        last evaluation (rate-limited by ``DDSTORE_SLO_WINDOW_MS``).
        Returns breach rows ``[tenant_slot, pct, threshold_ns,
        measured_low_ns, window_count]`` — a breach means the
        p-quantile's whole log2 bucket lies above the objective."""
        cap = 64
        arr = (ctypes.c_int64 * (cap * 6))()
        n = int(self._call(self._lib.dds_slo_evaluate, arr, cap))
        if n < 0:
            raise DDStoreError(n, "slo_evaluate")
        return [list(arr[i * 6:i * 6 + 5]) for i in range(n)]

    def slo_stats(self) -> dict:
        """SLO monitor counters (:data:`SLO_STAT_KEYS`)."""
        arr = (ctypes.c_int64 * 8)()
        _check(self._call(self._lib.dds_slo_stats, arr), "slo_stats")
        return dict(zip(SLO_STAT_KEYS, list(arr)[:len(SLO_STAT_KEYS)]))

    # -- replication / failover / heartbeat -------------------------------

    @property
    def replication(self) -> int:
        """Replication factor in force (``DDSTORE_REPLICATION`` clamped
        to ``[1, world]``; 1 = off, exactly the pre-replication tree)."""
        return int(self._call(self._lib.dds_replication))

    def replicate(self, name: str) -> None:
        """Pull/refresh this rank's mirrors of ``name`` (the shards of
        the next R-1 ranks). Call AFTER the registration barrier."""
        _check(self._call(self._lib.dds_replicate, name.encode()),
               f"replicate({name})")

    def refresh_mirrors(self) -> None:
        """Re-pull every mirror this rank hosts, creating missing ones
        (the elastic-recovery rebuild). Suspected/unreachable owners
        are skipped, never fatal."""
        _check(self._call(self._lib.dds_refresh_mirrors), "refresh_mirrors")

    def replica_set(self, owner: int) -> list:
        """Replica chain of ``owner``'s shard, primary first."""
        cap = 64
        arr = (ctypes.c_int * cap)()
        n = self._call(self._lib.dds_replica_set, int(owner), arr, cap)
        if n < 0:
            raise DDStoreError(n, f"replica_set({owner})")
        return list(arr)[:n]

    def health_state(self) -> list:
        """Per-peer suspicion flags (union of heartbeat verdicts and
        data-path ladder give-ups), one bool per rank."""
        cap = 1024
        arr = (ctypes.c_int64 * cap)()
        n = self._call(self._lib.dds_health_state, arr, cap)
        if n < 0:
            return []
        return [bool(v) for v in list(arr)[:n]]

    def heartbeat_configure(self, interval_ms: int,
                            suspect_n: int = 0) -> None:
        """(Re)start the heartbeat detector at ``interval_ms`` (<= 0
        stops it; ``suspect_n`` <= 0 keeps the env/default threshold)."""
        _check(self._call(
            self._lib.dds_heartbeat_configure,
            int(interval_ms), int(suspect_n)),
            "heartbeat_configure")

    def mark_suspect(self, target: int, suspected: bool = True) -> None:
        """Force one peer into (or out of) the suspect set — the
        deterministic failover-routing hook tests use."""
        _check(self._call(self._lib.dds_mark_suspect, int(target),
                          int(bool(suspected))),
               f"mark_suspect({target})")

    def failover_stats(self) -> dict:
        """Replicated-read failover + heartbeat counters
        (:data:`FAILOVER_STAT_KEYS`): reroutes served from replicas,
        detector short-circuits (zero deadline burned), whole-replica-
        set losses, mirror fill/refresh traffic, and the ping ledger.
        Monotone except the :data:`FAILOVER_GAUGE_KEYS` gauges."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_failover_stats, arr),
               "failover_stats")
        return dict(zip(FAILOVER_STAT_KEYS,
                        list(arr)[:len(FAILOVER_STAT_KEYS)]))

    @property
    def barrier_seq(self) -> int:
        """The transport's collective sequence count (elastic rejoin
        syncs a fresh rank to the group's)."""
        return int(self._call(self._lib.dds_barrier_seq))

    def set_barrier_seq(self, seq: int) -> None:
        _check(self._call(self._lib.dds_set_barrier_seq, seq),
               "set_barrier_seq")

    # -- data plane --------------------------------------------------------

    def add(self, name: str, arr: np.ndarray, all_nrows: Sequence[int],
            copy: bool = True) -> None:
        assert arr.flags["C_CONTIGUOUS"], "shard must be C-contiguous"
        nrows = arr.shape[0] if arr.ndim else 0
        # disp comes from the trailing dims, NOT size//nrows: an empty shard
        # (nrows=0) must still agree with its peers on the row width.
        disp = int(np.prod(arr.shape[1:], dtype=np.int64)) if arr.ndim > 1 else 1
        table = np.ascontiguousarray(all_nrows, dtype=np.int64)
        _check(self._call(
            self._lib.dds_add, name.encode(), arr.ctypes.data, nrows, disp,
            arr.itemsize, _as_i64p(table), int(copy)), f"add({name})")

    def init(self, name: str, nrows: int, disp: int, itemsize: int,
             all_nrows: Sequence[int]) -> None:
        table = np.ascontiguousarray(all_nrows, dtype=np.int64)
        _check(self._call(self._lib.dds_init, name.encode(), nrows, disp,
                          itemsize, _as_i64p(table)), f"init({name})")

    def update(self, name: str, arr: np.ndarray, row_offset: int) -> None:
        assert arr.flags["C_CONTIGUOUS"]
        nrows = arr.shape[0] if arr.ndim else 0
        _check(self._call(self._lib.dds_update, name.encode(), arr.ctypes.data,
                          nrows, row_offset), f"update({name})")

    def get(self, name: str, out: np.ndarray, start: int,
            count: int, tenant: str = "") -> None:
        assert out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]
        _check(self._call(self._lib.dds_get, name.encode(), out.ctypes.data,
                          start, count, tenant.encode()),
               f"get({name}, {start})")

    def get_batch(self, name: str, out: np.ndarray,
                  starts: np.ndarray, tenant: str = "") -> None:
        assert out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        _check(self._call(self._lib.dds_get_batch, name.encode(),
                          out.ctypes.data, _as_i64p(starts),
                          len(starts), tenant.encode()),
               f"get_batch({name})")

    # -- async batched reads ----------------------------------------------
    #
    # The epoch-readahead engine's native leg: the read runs on the
    # store's background pool while Python keeps planning/consuming. The
    # caller must keep `out` alive until the ticket completes (the
    # high-level AsyncBatchRead handle holds the reference); `starts` is
    # copied at issue time.

    def get_batch_async(self, name: str, out: np.ndarray,
                        starts: np.ndarray, tenant: str = "") -> int:
        assert out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        ticket = self._call(
            self._lib.dds_get_batch_async,
            name.encode(), out.ctypes.data, _as_i64p(starts),
            len(starts), tenant.encode())
        if ticket < 0:
            raise DDStoreError(int(ticket), f"get_batch_async({name})")
        return int(ticket)

    def read_runs_async(self, name: str, out: np.ndarray,
                        targets: np.ndarray, src_off: np.ndarray,
                        dst_off: np.ndarray, nbytes: np.ndarray,
                        tenant: str = "") -> int:
        """Async vectored run read: the caller's pre-coalesced per-peer
        runs executed verbatim (O(runs), not O(rows)) — the readahead
        window fast path. Bounds of every dst span are validated here;
        src spans are validated by the local/remote read legs."""
        assert out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]
        arrs = [np.ascontiguousarray(a, dtype=np.int64)
                for a in (targets, src_off, dst_off, nbytes)]
        n = len(arrs[0])
        if not all(len(a) == n for a in arrs):
            raise ValueError("read_runs_async: array length mismatch")
        if n and int((arrs[2] + arrs[3]).max()) > out.nbytes:
            raise ValueError("read_runs_async: dst span exceeds out")
        ticket = self._call(
            self._lib.dds_read_runs_async,
            name.encode(), out.ctypes.data, _as_i64p(arrs[0]),
            _as_i64p(arrs[1]), _as_i64p(arrs[2]), _as_i64p(arrs[3]), n,
            tenant.encode())
        if ticket < 0:
            raise DDStoreError(int(ticket), f"read_runs_async({name})")
        return int(ticket)

    def async_wait(self, ticket: int, timeout_ms: int = -1):
        """Wait for an async read. Returns ``(status, done_mono_s)``:
        status 1 = done ok, 0 = timeout, <0 = the read's error code.
        ``done_mono_s`` is the completion time on the time.monotonic()
        clock (producer-idle accounting). The status is returned raw —
        the high-level handle must release the ticket even for a failed
        read, so raising here would leak it."""
        ts = ctypes.c_double(0.0)
        rc = self._call(self._lib.dds_async_wait, ticket, timeout_ms,
                        ctypes.byref(ts))
        return rc, ts.value

    def async_release(self, ticket: int) -> int:
        """Block until the read completes, then free the ticket. Returns
        the read's error code (0 = ok) — never raises: release is the
        teardown barrier and must always free the slot. On a closed store
        it returns :data:`ERR_CLOSED` (the tickets went with the store)."""
        try:
            return int(self._call(self._lib.dds_async_release, ticket))
        except DDStoreError as e:
            return e.code

    @property
    def async_pending(self) -> int:
        """Unreleased async tickets (0 after a clean loader teardown)."""
        return int(self._call(self._lib.dds_async_pending))

    def query(self, name: str):
        total = _i64(0)
        disp = _i64(0)
        itemsize = _i64(0)
        local = _i64(0)
        _check(self._call(self._lib.dds_query, name.encode(),
                          ctypes.byref(total), ctypes.byref(disp),
                          ctypes.byref(itemsize), ctypes.byref(local)),
               f"query({name})")
        return {"total_rows": total.value, "disp": disp.value,
                "itemsize": itemsize.value, "local_rows": local.value}

    # -- control plane -----------------------------------------------------

    def epoch_begin(self) -> None:
        _check(self._call(self._lib.dds_epoch_begin), "epoch_begin")

    def epoch_end(self) -> None:
        _check(self._call(self._lib.dds_epoch_end), "epoch_end")

    def set_epoch_collective(self, collective: bool) -> None:
        _check(self._call(self._lib.dds_set_epoch_collective, int(collective)))

    def fence_reset(self) -> None:
        """Force the epoch-fence state machine closed (local,
        idempotent) — the elastic-recovery realignment hook: a fence
        abort need not be unanimous (a victim that partially
        disseminated its barrier notifies can let some survivors
        complete the fence while others roll back), so ``recover()``
        resets every rank to one agreed pre-fence state before the
        group re-enters its first post-recovery epoch."""
        _check(self._call(self._lib.dds_fence_reset), "fence_reset")

    def rebind(self, name: str, arr: np.ndarray) -> None:
        """Atomically swap the local shard's backing memory to ``arr``
        (same length, identical contents — e.g. a fresh mmap of the
        just-spilled shard). The store borrows the buffer; the caller
        keeps it alive. Concurrent readers see old or new bytes, never a
        missing variable."""
        assert arr.flags["C_CONTIGUOUS"]
        _check(self._call(self._lib.dds_rebind, name.encode(),
                          arr.ctypes.data if arr.size else None),
               f"rebind({name})")

    def free_var(self, name: str) -> None:
        _check(self._call(self._lib.dds_free_var, name.encode()),
               f"free({name})")

    def barrier(self, tag: int) -> None:
        _check(self._call(self._lib.dds_barrier, tag), "barrier")

    @property
    def cma_ops(self) -> int:
        """Reads served via the same-host CMA fast path (shared-memory
        mapped gather, or process_vm_readv for borrowed shards); 0 for
        non-TCP backends or when DDSTORE_CMA=0."""
        return self._call(self._lib.dds_cma_ops)

    def plan_stats(self) -> dict:
        """Cumulative scatter-read planner statistics (``get_batch``):
        batches/rows planned, coalesced runs emitted (local + per-peer),
        remote per-peer run lists issued, duplicate rows served by
        post-fetch replication, and scratch staging volume. Derived:
        ``coalesce_ratio`` = unique rows fetched per transport run (1.0 =
        nothing coalesced; higher = fewer, larger segments on the wire)."""
        arr = (ctypes.c_int64 * 8)()
        _check(self._call(self._lib.dds_plan_stats, arr), "plan_stats")
        (batches, rows, runs, local_runs, peer_lists, dedup_hits,
         scratch_runs, scratch_bytes) = list(arr)
        raw = {
            "plan_batches": batches,
            "plan_rows": rows,
            "plan_runs": runs,
            "plan_local_runs": local_runs,
            "plan_peer_lists": peer_lists,
            "plan_dedup_hits": dedup_hits,
            "plan_scratch_runs": scratch_runs,
            "plan_scratch_bytes": scratch_bytes,
        }
        # Deriving the ratios via a zero-baseline delta keeps their
        # definitions single-sourced in utils.metrics (lazy import:
        # binding must stay importable before the package's siblings).
        from .utils.metrics import plan_stats_delta

        return plan_stats_delta({}, raw)

    # -- end-to-end data integrity -----------------------------------------

    def integrity_configure(self, verify: int = -1,
                            scrub_ms: int = -1) -> None:
        """Runtime integrity toggles (load-time: ``DDSTORE_VERIFY`` /
        ``DDSTORE_SCRUB_MS``): ``verify`` -1 keeps / 0 off / 1 on
        (reader-side checksum verification; also enables sum
        computation); ``scrub_ms`` -1 keeps / 0 stops the background
        scrubber / >0 (re)starts it at that per-mirror tick."""
        _check(self._call(
            self._lib.dds_integrity_configure, int(verify), int(scrub_ms)),
            f"integrity_configure({verify}, {scrub_ms})")

    def integrity_stats(self) -> dict:
        """Integrity counters (:data:`INTEGRITY_STAT_KEYS`): sum-table
        builds/serves, verified reads/bytes, mismatch/retry/failover
        ladder activity, surfaced ``ERR_CORRUPT`` errors and the
        scrubber's checked/divergent/repaired ledger. Monotone except
        the :data:`INTEGRITY_GAUGE_KEYS` gauges."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_integrity_stats, arr),
               "integrity_stats")
        return dict(zip(INTEGRITY_STAT_KEYS,
                        list(arr)[:len(INTEGRITY_STAT_KEYS)]))

    def integrity_sums(self, name: str, row0: int = 0,
                       count: Optional[int] = None):
        """The LOCAL shard's per-row checksum table slice ``[row0,
        row0+count)`` as ``(sums, seq)`` — ``sums`` a uint64 array,
        ``seq`` the content version it describes. Builds the table
        lazily; raises while integrity is disabled. Test/debug hook."""
        if count is None:
            count = int(self.query(name)["local_rows"]) - row0
        out = np.empty(max(int(count), 0), dtype=np.uint64)
        seq = _i64(-1)
        _check(self._call(
            self._lib.dds_integrity_sums, name.encode(), int(row0), int(count),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.byref(seq)), f"integrity_sums({name})")
        return out, int(seq.value)

    def integrity_scrub(self) -> int:
        """One synchronous scrub pass over every resident mirror;
        returns the number of divergent mirrors found (repairs run
        inline, counted in :meth:`integrity_stats`)."""
        n = int(self._call(self._lib.dds_integrity_scrub))
        if n < 0:
            raise DDStoreError(n, "integrity_scrub")
        return n

    # -- tiered storage: hot-row cache + cold placement --------------------

    def tier_configure(self, cache_bytes: int = -1) -> None:
        """Runtime hot-row cache budget (bytes; 0 disables and evicts
        everything, < 0 keeps). Load-time:
        ``DDSTORE_TIER_CACHE_BYTES``."""
        _check(self._call(self._lib.dds_tier_configure, int(cache_bytes)),
               f"tier_configure({cache_bytes})")

    def set_var_tier(self, name: str, tier: int) -> None:
        """Record a registered variable's storage tier (0 = hot
        RAM/shm, 1 = cold file-backed mmap). Drives the
        ``cold_vars``/``cold_bytes`` gauges; serving is tier-agnostic."""
        _check(self._call(self._lib.dds_set_var_tier, name.encode(),
                          int(tier)),
               f"set_var_tier({name})")

    def var_tier(self, name: str) -> int:
        """The recorded tier of ``name`` (0 hot, 1 cold)."""
        rc = int(self._call(self._lib.dds_var_tier, name.encode()))
        if rc < 0:
            raise DDStoreError(rc, f"var_tier({name})")
        return rc

    def set_tier_placement(self, tenant: str, cold: bool) -> None:
        """Placement policy for ``tenant``'s mirror fills and snapshot
        kept copies: cold lands them file-backed under
        ``DDSTORE_TIER_COLD_DIR`` (load-time:
        ``DDSTORE_TIER_PLACEMENT``)."""
        _check(self._call(
            self._lib.dds_set_tier_placement,
            tenant.encode(), 1 if cold else 0),
            f"set_tier_placement({tenant})")

    def cache_prefetch(self, name: str, rows, window: int = 0,
                       tenant: str = "") -> None:
        """Warm the hot-row cache with sorted-unique global ``rows`` of
        ``name`` as window ``window`` (the eviction key); the fill runs
        detached on the native async pool, charged against the reading
        ``tenant``'s byte quota until eviction. Advisory: disabled /
        duplicate / over-budget calls are counted no-ops."""
        idx = np.ascontiguousarray(rows, dtype=np.int64).reshape(-1)
        rc = int(self._call(
            self._lib.dds_cache_prefetch,
            name.encode(), _as_i64p(idx), idx.size,
            int(window), tenant.encode()))
        if rc < 0:
            raise DDStoreError(rc, f"cache_prefetch({name})")

    def cache_evict(self, window: int = -1) -> int:
        """Evict window ``window``'s cache entries (< 0: every entry),
        releasing their quota charges. Returns the count evicted."""
        rc = int(self._call(self._lib.dds_cache_evict, int(window)))
        if rc < 0:
            raise DDStoreError(rc, f"cache_evict({window})")
        return rc

    def tiering_stats(self) -> dict:
        """Tiering counters (:data:`TIERING_STAT_KEYS`): cache budget/
        occupancy gauges, cold-tier registrations, and the monotone
        hit/miss/fill/evict ledger."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_tiering_stats, arr),
               "tiering_stats")
        return dict(zip(TIERING_STAT_KEYS,
                        list(arr)[:len(TIERING_STAT_KEYS)]))

    # -- io_uring data plane -----------------------------------------------

    def uring_state(self) -> int:
        """1 = uring handle with the ring engaged, 0 = uring handle
        serving through the TCP fallback (kernel refused the probe),
        -1 = not a uring handle."""
        return int(self._call(self._lib.dds_uring_state))

    def uring_reason(self) -> str:
        """This handle's engagement/fallback reason ("ok" when
        engaged; e.g. "io_uring_setup: Operation not permitted" under
        a gVisor-class kernel). Empty string for non-uring handles."""
        buf = ctypes.create_string_buffer(256)
        rc = int(self._call(self._lib.dds_uring_reason, buf, 256))
        if rc < 0:
            return ""
        return buf.value.decode(errors="replace")

    def uring_stats(self) -> dict:
        """Wire-loop counters (:data:`URING_STAT_KEYS`). Raises on
        non-uring handles."""
        arr = (ctypes.c_int64 * 7)()
        _check(self._call(self._lib.dds_uring_stats, arr), "uring_stats")
        return dict(zip(URING_STAT_KEYS, list(arr)))

    def cold_direct_stats(self) -> dict:
        """Cold-tier O_DIRECT reader counters
        (:data:`COLD_DIRECT_STAT_KEYS`); zeros until a var registers
        via :meth:`set_var_file`. Works on every handle kind."""
        arr = (ctypes.c_int64 * 6)()
        _check(self._call(self._lib.dds_cold_direct_stats, arr),
               "cold_direct_stats")
        return dict(zip(COLD_DIRECT_STAT_KEYS, list(arr)))

    def set_var_file(self, name: str, path: str) -> bool:
        """Register a READONLY cold (tier-1) var's backing file so its
        local reads go O_DIRECT through the submission ring instead of
        faulting the mmap. Returns False (never raises) when io_uring
        or O_DIRECT is unavailable — the var stays on the mmap path,
        which serves identical bytes."""
        rc = int(self._call(self._lib.dds_set_var_file, name.encode(),
                            path.encode()))
        if rc in (ERR_NOT_FOUND, ERR_INVALID_ARG):
            raise DDStoreError(rc, f"set_var_file({name})")
        return rc == 0

    def req_send_stats(self) -> dict:
        """Requester-side TCP pipeline send-gather counters:
        ``req_frames`` / ``req_sends``. Their ratio is the writev
        gather factor of the half-window refill (1.0 = the old
        one-sendmsg-per-frame steady state)."""
        arr = (ctypes.c_int64 * 2)()
        _check(self._call(self._lib.dds_req_send_stats, arr),
               "req_send_stats")
        return {"req_frames": int(arr[0]), "req_sends": int(arr[1])}

    def fault_stats(self) -> dict:
        """Fault-injection + transient-retry counters: the process-global
        injector's draws/injections (``fault_checks``/``injected_*``) plus
        THIS handle's retry layer (``retry_*`` — TCP leaf retries and the
        store-level layer summed, monotone since store creation;
        ``last_error_peer`` names the most recent failed target, -1 =
        none). A seeded schedule reproduces these counters exactly across
        identical runs — the determinism the chaos tests pin."""
        arr = (ctypes.c_int64 * 16)()
        _check(self._call(self._lib.dds_fault_stats, arr), "fault_stats")
        return dict(zip(FAULT_STAT_KEYS, list(arr)[:len(FAULT_STAT_KEYS)]))

    @property
    def rank(self) -> int:
        return self._call(self._lib.dds_rank)

    @property
    def world(self) -> int:
        return self._call(self._lib.dds_world)

    def close(self) -> None:
        """Free the native store, once. Calls that start from here on
        raise :data:`ERR_CLOSED`; ``dds_destroy`` runs when the calls
        already in flight on other threads have returned. A call that
        blocks (a barrier, or a read of a dead peer) holds ``close`` until
        it returns, within the store's own retry deadline
        (``DDSTORE_OP_DEADLINE_S``). Idempotent: a second ``close``, or
        one that another thread's ``close`` is still waiting in, returns
        at once."""
        with self._lock:
            if self._closing:
                return
            self._closing = True
            self._idle.wait_for(lambda: not self._in_flight)
            h, self._h = self._h, 0
        self._lib.dds_destroy(h)
        if self._local_gid is not None:
            # Drop the process-global LocalGroup registry entry (peers
            # that still exist keep the group alive via shared_ptr).
            self._lib.dds_release_local_group(self._local_gid.encode())
            self._local_gid = None

    def __del__(self):  # best-effort teardown
        try:
            self.close()
        except Exception:
            pass
