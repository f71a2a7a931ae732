"""The port's ``PipelineMetrics`` store-sourced summaries and its
histogram helpers (``utils/metrics.py``, ``obs``) against the JAX
package's, and their wiring in the port's loader.

Both packages' ``PipelineMetrics`` are fed the same canned sources
(cumulative counters that move between an epoch's start and end, the
raw histogram cell arrays, a scheduler snapshot) and must produce the
same ``summary()`` sections key for key: scatter plan, faults, failover,
integrity, tiering, live latency, SLOs, gateway, per-lane bytes, sched,
plus the collective ledger and degraded-mode events. The histogram
helpers mirror ``tests/test_metrics_hist.py``'s units (bucket math,
clamps across a reset, deltas). A port loader over a 2-rank TCP store
carries the store's sections in its epoch summary."""

import uuid

import numpy as np
import pytest

from ddstore_tpu import obs as robs
from ddstore_tpu.binding import METRICS_CELL_DTYPE as REF_CELL_DTYPE
from ddstore_tpu.utils.metrics import PipelineMetrics as RefMetrics
from ddstore_tpu_torch import obs as tobs
from ddstore_tpu_torch.binding import METRICS_CELL_DTYPE
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.rendezvous import ThreadGroup
from ddstore_tpu_torch.store import DDStore
from ddstore_tpu_torch.utils.metrics import PipelineMetrics
from torch_workers import run_threads

pytestmark = pytest.mark.tier1_required

TIMING = ("input_pipeline_efficiency", "total_s", "device_wait",
          "host_fetch", "device_put")


class _Counter:
    """A cumulative-counter source: ``begin`` at epoch start, ``end``
    after it (each call returns the current values)."""

    def __init__(self, begin, end):
        self.state = [begin, end]
        self.i = 0

    def advance(self):
        self.i = 1

    def __call__(self):
        v = self.state[self.i]
        return {k: dict(x) if isinstance(x, dict) else x
                for k, x in v.items()} if isinstance(v, dict) else v


def _cells(rows):
    out = np.zeros(len(rows), dtype=METRICS_CELL_DTYPE)
    for c, (cls, route, peer, tenant, count, lat_b, byt) in zip(out, rows):
        c["cls"], c["route"], c["peer"] = cls, route, peer
        c["tenant"] = tenant.encode()
        c["count"], c["lat_sum_ns"] = count, count * (1 << lat_b)
        c["lat"][lat_b] = count
        c["bytes_sum"] = byt * count
        c["bytes"][max(0, int(byt).bit_length() - 1)] = count
    return out


SOURCES = {
    "plan": ("set_plan_source", {
        "plan_batches": 3, "plan_rows": 90, "plan_runs": 30,
        "plan_local_runs": 5, "plan_peer_lists": 6, "plan_dedup_hits": 2,
        "plan_scratch_runs": 1, "plan_scratch_bytes": 64},
        {"plan_batches": 9, "plan_rows": 290, "plan_runs": 70,
         "plan_local_runs": 15, "plan_peer_lists": 16,
         "plan_dedup_hits": 12, "plan_scratch_runs": 3,
         "plan_scratch_bytes": 640}),
    "fault": ("set_fault_source", {
        "injected_reset": 1, "retries": 4, "retry_giveups": 0,
        "last_error_peer": -1},
        {"injected_reset": 0, "retries": 9, "retry_giveups": 1,
         "last_error_peer": 1}),
    "failover": ("set_failover_source", {
        "replication": 2, "hb_active": 1, "suspected_now": 0,
        "failovers": 1, "suspects": 0},
        {"replication": 2, "hb_active": 1, "suspected_now": 1,
         "failovers": 4, "suspects": 1}),
    "integrity": ("set_integrity_source", {
        "verify_mode": 1, "sums_tables": 2, "last_corrupt_peer": -1,
        "verified_reads": 10, "verify_mismatches": 0},
        {"verify_mode": 1, "sums_tables": 2, "last_corrupt_peer": 1,
         "verified_reads": 50, "verify_mismatches": 3}),
    "tiering": ("set_tiering_source", {
        "cache_max_bytes": 1 << 20, "cache_bytes": 10, "cache_entries": 1,
        "cold_vars": 0, "cold_bytes": 0, "cache_hit_bytes": 100,
        "cache_miss_bytes": 50},
        {"cache_max_bytes": 1 << 20, "cache_bytes": 99,
         "cache_entries": 4, "cold_vars": 1, "cold_bytes": 7,
         "cache_hit_bytes": 400, "cache_miss_bytes": 150}),
    "slo": ("set_slo_source", {
        "rules": 1, "evaluations": 2, "breaches": 0, "window_ms": 0,
        "last_breach_tenant_slot": -1, "last_breaches": []},
        {"rules": 1, "evaluations": 5, "breaches": 1, "window_ms": 0,
         "last_breach_tenant_slot": 0,
         "last_breaches": [{"tenant": "", "p99_ms": 3.0}]}),
    "gateway": ("set_gateway_source", {
        "enabled": 1, "sessions": 1, "draining": 0, "inflight": 0,
        "deferred_now": 0, "last_retry_after_ms": 0, "attaches": 1,
        "admitted": 10, "deferred": 0, "rejected": 0},
        {"enabled": 1, "sessions": 2, "draining": 0, "inflight": 1,
         "deferred_now": 1, "last_retry_after_ms": 5, "attaches": 3,
         "admitted": 30, "deferred": 2, "rejected": 1}),
    "lane": ("set_lane_source", [100, 0, 50], [400, 10, 350, 7]),
    "latency": ("set_latency_source",
                _cells([(1, 1, 1, "", 3, 10, 64), (0, 0, -1, "", 2, 5, 8)]),
                _cells([(1, 1, 1, "", 10, 12, 64), (0, 0, -1, "", 2, 5, 8),
                        (2, 3, 0, "eval", 4, 20, 4096)])),
}


def _drive(cls, which):
    m = cls()
    srcs = []
    for name in which:
        setter, begin, end = SOURCES[name]
        src = _Counter(begin, end)
        srcs.append(src)
        getattr(m, setter)(src)
    m.epoch_start()
    for s in srcs:
        s.advance()
    m.add_bytes(bytes_local_get=100, bytes_over_ici=50, rows_over_ici=3)
    m.add_fault_event(collective_batch_fallbacks=1, readahead_degraded=1)
    m.add_window(wait_s=0.01, idle_s=0.0, fetch_s=0.02, rows_requested=8,
                 rows_unique=6, dup_rows=2, runs=3, remote_runs=2,
                 peer_lists=1, window_bytes=600)
    m.set_sched_source(lambda: {"enabled": True, "replans": 2})
    mid = {k: v for k, v in m.summary().items() if k not in TIMING}
    m.epoch_end()
    return mid, {k: v for k, v in m.summary().items() if k not in TIMING}


@pytest.mark.parametrize("which", sorted(SOURCES) + ["all"])
def test_source_summaries_equal_reference(which):
    names = sorted(SOURCES) if which == "all" else [which]
    got_mid, got = _drive(PipelineMetrics, names)
    want_mid, want = _drive(RefMetrics, names)
    assert got == want
    assert got_mid == want_mid  # live (mid-epoch) deltas too
    if which != "all":
        assert {"bytes_moved", "faults", "readahead", "sched"} <= set(got)


def test_summary_sections_absent_without_activity():
    got_mid, got = _drive(PipelineMetrics, [])
    want_mid, want = _drive(RefMetrics, [])
    assert got == want
    for key in ("scatter_plan", "failover", "integrity", "tiering",
                "latency", "slo", "gateway"):
        assert key not in got


def test_cell_dtype_equals_reference():
    assert METRICS_CELL_DTYPE == REF_CELL_DTYPE


@pytest.mark.parametrize("q", [1, 50, 90, 99, 100])
def test_hist_percentile_matches_reference(q):
    rng = np.random.default_rng(q)
    for _ in range(5):
        hist = rng.integers(0, 5, size=44).astype(np.uint64)
        assert tobs.hist_percentile(hist, q) == robs.hist_percentile(hist, q)
    assert tobs.hist_percentile(np.zeros(44, np.uint64), q) == 0


def test_diff_metrics_clamps_across_reset():
    begin = _cells([(1, 1, -1, "", 10, 10, 0)])
    end = _cells([(1, 1, -1, "", 3, 10, 0)])  # post-reset
    d = tobs.diff_metrics(begin, end)
    assert int(d[0]["count"]) == 3 and int(d[0]["lat"][10]) == 3
    assert d.tobytes() == robs.diff_metrics(begin, end).tobytes()


def test_diff_and_table_match_reference():
    a = SOURCES["latency"][1]
    b = SOURCES["latency"][2]
    for begin, end in ((a, b), (None, b), (b, b), (a, a[:1])):
        got = tobs.diff_metrics(begin, end)
        assert got.tobytes() == robs.diff_metrics(begin, end).tobytes()
        assert tobs.latency_table(got) == robs.latency_table(got)
    assert len(tobs.diff_metrics(b, b)) == 0


def test_loader_epoch_carries_store_summaries(monkeypatch):
    """A port loader over a 2-rank TCP store: its epoch summary holds the
    scatter plan, the fault ledger, the live latency of the reads, the
    lanes and the scheduler's plan."""
    monkeypatch.delenv("DDSTORE_SCHED", raising=False)
    name = uuid.uuid4().hex
    data = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)

    def body(rank):
        with DDStore(ThreadGroup(name, rank, 2), backend="tcp") as s:
            ds = ShardedDataset(s, data)
            ld = DeviceLoader(ds, DistributedSampler(len(ds), 2, rank),
                              8, device="cpu", workers=1)
            n = sum(1 for _ in ld)
            m = ld.metrics.summary()
            s.barrier()
            return n, m

    for n, m in run_threads(2, body):
        assert n == 4
        assert m["scatter_plan"]["plan_batches"] == 4
        assert "faults" in m and m["faults"]["retry_giveups"] == 0
        assert any(k.startswith("get_batch|") for k in m["latency"])
        assert m["bytes_moved"]["bytes_over_dcn"] > 0
        assert m["sched"]["enabled"] and m["sched"]["replans"] >= 1
