// ddmetrics: always-on, zero-alloc log2-bucketed latency/bytes
// histograms per (op class, route, peer, reading tenant).
//
// ddtrace (trace.h) answers "WHAT happened to this op" — but only while
// DDSTORE_TRACE=1 pays a ring write per event, and its percentiles are
// computed post-hoc from dumps. The store's premise is that any rank
// reads any row over one-sided transport, which makes tail latency a
// CLUSTER property that must be observable LIVE: this module keeps
// per-store histograms updated at op end with a few relaxed atomic
// increments (no mutex, no allocation on the hot path), so
// summary()["latency"] can report live p50/p90/p99 per cell with
// tracing off — and the SLO monitor (store.h) can evaluate per-tenant
// latency objectives over the same counters every epoch window.
//
// Design:
// * A fixed open-addressed table of Cells per Registry (one Registry
//   per Store — a ThreadGroup's in-process "ranks" must not merge
//   their histograms the way the process-global trace rings do). A
//   cell is claimed once by CAS on its packed key and never freed;
//   overflow past kMaxCells is counted, never blocks.
// * Log2 buckets: bucket b of the latency histogram counts ops with
//   latency in [2^b, 2^(b+1)) ns (bucket 0 also absorbs 0/1 ns). Same
//   rule for the bytes histogram. Percentiles come back as the bucket
//   UPPER bound — conservative, and within one log2 bucket of the
//   exact trace-derived value by construction.
// * Route attribution matches obs.span_latency's rule: "cma" when a
//   CMA read served any leg, else "tcp" when a wire leg ran, else
//   "local". The transport marks the route on the thread-local token
//   (OpTimer) from the op's OWN calling thread — leaf pool tasks
//   never touch it, so no cross-thread propagation is needed.
// * Snapshot/serve: cells serialize into packed CellRecords (binding
//   METRICS_CELL_DTYPE) read lock-free with the ddtrace discipline —
//   the claim key is load-acquired after its store-release, so a
//   half-claimed cell is never misread; counter reads are relaxed
//   (monotone counters; a snapshot is a monitoring cut, not a fence).
//
// DDSTORE_METRICS=0 disables at load (default ON — the histograms are
// the always-on substrate); dds_metrics_configure flips at runtime.
// Disabled cost: one relaxed load per op. Histograms never touch
// bytes, error codes, or fault-injector draws in either state.

#ifndef DDSTORE_TPU_METRICS_HIST_H_
#define DDSTORE_TPU_METRICS_HIST_H_

#include <atomic>
#include <cstdint>
#include <memory>
#include <mutex>
#include <string>

#include "thread_annotations.h"

namespace dds {
namespace metrics {

// Op classes match trace.h OpClass (get/get_batch/read_runs/
// async_batch) so live cells and span_latency keys line up 1:1.
constexpr int kNumClasses = 4;

// Route of an op's dominant leg. Ordered by span_latency's attribution
// precedence (uring beats cma beats tcp beats local) so
// OpTimer::MarkRoute is a plain max-upgrade. A mixed cma+uring batch
// attributes to uring: the io_uring wire leg is the one whose regression
// the histogram plane must surface (the cma leg is unchanged by it).
enum Route : int { kRouteLocal = 0, kRouteTcp = 1, kRouteCma = 2,
                   kRouteUring = 3 };
constexpr int kNumRoutes = 4;

// Log2 buckets. 44 covers [1 ns, ~4.9 h) for latency and
// [1 B, 16 TiB) for bytes; values past the top clamp into the last
// bucket.
constexpr int kBuckets = 44;

// Cell table capacity per store. classes(4) x routes(3) x peers x
// tenants: 512 covers a 16-rank pod with ~10 active tenants; overflow
// is counted (dropped_cells), never blocks.
constexpr int kMaxCells = 512;

// Interned reading-tenant labels per store. Slot 0 is the default
// tenant ""; overflow folds into slot 0 and is counted.
constexpr int kMaxTenants = 24;
constexpr int kTenantNameCap = 48;  // bytes, including the NUL

// floor(log2(v)) clamped to [0, kBuckets-1]; v <= 1 lands in bucket 0.
inline int BucketOf(uint64_t v) {
  if (v <= 1) return 0;
  const int b = 63 - __builtin_clzll(v);
  return b < kBuckets ? b : kBuckets - 1;
}
// Lower bound of bucket b (inclusive). BucketHigh is the next bucket's
// low — the conservative percentile read-out.
inline uint64_t BucketLow(int b) {
  return b <= 0 ? 0 : (1ull << b);
}
inline uint64_t BucketHigh(int b) { return 1ull << (b + 1); }

// The packed snapshot record (binding.py METRICS_CELL_DTYPE — keep in
// sync). One per claimed cell; `tenant` is the interned label,
// NUL-padded.
#pragma pack(push, 1)
struct CellRecord {
  int32_t cls;
  int32_t route;
  int32_t peer;       // -1 = multi-peer (batched ops)
  int32_t reserved;
  char tenant[kTenantNameCap];
  uint64_t count;         // ops recorded (one latency+bytes sample each)
  uint64_t lat_sum_ns;
  uint64_t lat[kBuckets];
  uint64_t bytes_sum;
  uint64_t bytes[kBuckets];
};
#pragma pack(pop)

// Stats layout (binding.py METRICS_STAT_KEYS — keep in sync):
// [enabled, cells, cells_cap, dropped_cells, tenants, tenant_overflow,
//  ops_recorded, 0].
constexpr int kNumStats = 8;

class Registry {
 public:
  Registry();

  // THE hot-path gate: one relaxed load per op.
  bool enabled() const {
    return enabled_.load(std::memory_order_relaxed) != 0;
  }
  // Runtime switch (-1 keeps). Returns 0.
  int Configure(int enabled);
  // Zero every claimed cell's counters (keys/tenants stay interned —
  // a live writer may be mid-increment; counts restart near zero).
  void Reset();

  // Interned id of a reading-tenant label ("" = 0). Lock-free on every
  // already-seen label (append-only slot array, acquire/release
  // published); a NEW label takes the control-plane mutex once. A full
  // table folds into slot 0 and counts tenant_overflow.
  int TenantId(const std::string& tenant);
  // CSV of interned labels in slot order; the default tenant is the
  // leading empty field (",t1,t2"). Returns bytes written.
  int TenantNamesCsv(char* out, int cap) const;

  // Fold one completed op into its cell: a few relaxed increments.
  void Record(int cls, int route, int peer, int tenant_id,
              uint64_t lat_ns, uint64_t bytes);

  // Serialize every claimed, non-empty cell as CellRecords. out ==
  // nullptr returns the worst-case byte size (kMaxCells records);
  // otherwise the bytes written (a multiple of sizeof(CellRecord)).
  int64_t Snapshot(void* out, int64_t cap_bytes) const;

  // Cumulative latency histogram of ONE tenant aggregated across all
  // of its cells (every class/route/peer) — the SLO monitor's input.
  // Monotone: cells only accumulate and claims only add, so a baseline
  // subtraction of two aggregates is a valid per-window histogram.
  void TenantLatHist(int tenant_id, uint64_t hist[kBuckets],
                     uint64_t* count) const;

  void Stats(int64_t out[kNumStats]) const;

 private:
  struct Cell {
    // 0 = free. Packed: claim bit | cls | route | tenant | peer+1
    // (see PackKey) — store-released by the claiming writer,
    // load-acquired by readers.
    std::atomic<uint64_t> key{0};
    std::atomic<uint64_t> count{0};
    std::atomic<uint64_t> lat_sum_ns{0};
    std::atomic<uint64_t> lat[kBuckets];
    std::atomic<uint64_t> bytes_sum{0};
    std::atomic<uint64_t> bytes[kBuckets];
    Cell() {
      for (auto& b : lat) b.store(0, std::memory_order_relaxed);
      for (auto& b : bytes) b.store(0, std::memory_order_relaxed);
    }
  };
  static uint64_t PackKey(int cls, int route, int peer, int tenant_id);
  Cell* FindCell(uint64_t key);

  std::atomic<uint32_t> enabled_{1};
  const std::unique_ptr<Cell[]> cells_;  // fixed table, never resized
  std::atomic<int64_t> dropped_{0};      // table-full samples
  std::atomic<int64_t> recorded_{0};
  std::atomic<int64_t> tenant_overflow_{0};

  // Tenant interning: slots are written ONCE (under mu_, before the
  // count's store-release) and immutable afterwards; readers scan
  // [0, count) lock-free after an acquire load of the count. mu_ is
  // control-plane only — a label's FIRST appearance per store.
  struct TenantSlot {
    char name[kTenantNameCap];
  };
  mutable std::mutex mu_ DDS_NO_BLOCKING;
  TenantSlot tenant_slots_[kMaxTenants];
  std::atomic<int> tenant_count_{1};  // slot 0 = ""
};

// -- per-op timing token ------------------------------------------------------

// RAII around one top-level store op (the same sites trace::ScopedOp
// instruments). Latency is measured ctor->dtor unless an explicit
// issue-time t0 is passed (the async issue->completion bracket); the
// route starts "local" and transports upgrade it via MarkRoute from
// the op's own calling thread. ONE op = ONE sample: a timer
// constructed while another is active on this thread (the async
// bracket already timing its inner GetBatch/ReadRuns execution leg)
// is INERT — recording both would double-count the tenant's traffic
// and dilute the SLO quantile with the faster execution legs — so at
// most ONE token is ever live per thread and route marks land on it.
class OpTimer {
 public:
  // tenant_id: pre-interned reading tenant (Registry::TenantId).
  // t0_ns != 0 overrides the start time (issue-time async bracket).
  OpTimer(Registry* reg, int cls, int peer, int tenant_id,
          uint64_t bytes, uint64_t t0_ns = 0);
  ~OpTimer();
  OpTimer(const OpTimer&) = delete;
  OpTimer& operator=(const OpTimer&) = delete;

  // Upgrade the route of this thread's active token (cma wins over
  // tcp wins over local — span_latency's rule). No-op when no token
  // is active (leaf pool threads, nested/inert ops).
  static void MarkRoute(int route);

  // CLOCK_MONOTONIC ns (exposed for the async issue-time capture).
  static uint64_t NowNs();

 private:
  Registry* reg_;   // nullptr = inactive (metrics disabled at ctor)
  uint64_t t0_ns_ = 0;
  int cls_ = 0;
  int peer_ = -1;
  int tenant_ = 0;
  uint64_t bytes_ = 0;
  int route_ = kRouteLocal;
};

}  // namespace metrics
}  // namespace dds

#endif  // DDSTORE_TPU_METRICS_HIST_H_
