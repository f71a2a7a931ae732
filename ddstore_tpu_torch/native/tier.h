// Tiered storage primitives: the hot-row cache and the cold-file
// allocator.
//
// DDStore's premise is "any rank reads any row of a dataset too large
// for one node's RAM" — but until this module, the AGGREGATE dataset
// still had to fit in cluster RAM (every shard in /dev/shm or heap).
// Two pieces lift that:
//
//   * HotRowCache — a bounded, byte-budgeted RAM cache of row RANGES,
//     warmed asynchronously by the readahead planner's upcoming-window
//     row lists (the plan exists before the window is issued — a free
//     lookahead) and consulted on every top-level read entry point
//     (Get / GetBatch / ReadRuns). A cached run is served by one
//     memcpy instead of a cold-tier (NVMe page fault or wire) read;
//     eviction is keyed on window consumption, so the cache holds
//     exactly the readahead pipeline's working set.
//   * ColdAlloc/ColdFree — file-backed shard allocations under
//     DDSTORE_TIER_COLD_DIR for mirror fills and snapshot kept copies
//     whose tenant's placement policy says "cold": the bytes live in
//     page cache backed by NVMe, evictable under memory pressure,
//     instead of pinning RAM.
//
// The cache is OFF by default (max_bytes == 0): every hook below is
// behind one relaxed load, and the disabled tree is byte-,
// error-code- and seeded-fault-counter-identical to the pre-tiering
// store (the inertness discipline of every optional layer; pinned by test).

#ifndef DDSTORE_TPU_TIER_H_
#define DDSTORE_TPU_TIER_H_

#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

#include "thread_annotations.h"

namespace dds {
namespace tier {

// One warmed window of one variable: the sorted-unique global row ids
// and a dense RAM staging of their bytes. Entries are shared_ptr'd so
// an eviction racing a concurrent serve (or a still-writing fill)
// frees the buffer exactly once, when the last reference drops — the
// reader memcpys from its own reference outside the cache lock.
struct Entry {
  enum State { kFilling = 0, kReady = 1, kFailed = 2 };

  std::string name;             // registry name the rows belong to
  int64_t window = 0;           // caller's window id (eviction key)
  int64_t row_bytes = 0;
  std::vector<int64_t> rows;    // sorted unique global row ids
  std::unique_ptr<char[]> buf;  // rows.size() * row_bytes, dense
  // kFilling -> kReady|kFailed exactly once (the fill's completion);
  // serves read it with acquire so a ready entry's bytes are visible.
  std::atomic<int> state{kFilling};
  // Cache byte budget still reserved for this entry (released exactly
  // once, under the cache mutex, by whoever removes it from the map).
  bool charged DDS_GUARDED_BY(HotRowCache::mu_) = true;
  // Tenant-quota bytes charged at prefetch (0 = untracked tenant).
  // Released exactly once via the quota_live exchange — a failing
  // fill and a concurrent eviction must not both return the budget.
  std::string tenant;
  int64_t quota_charged = 0;
  std::atomic<bool> quota_live{false};

  int64_t bytes() const {
    return static_cast<int64_t>(rows.size()) * row_bytes;
  }
};

// Monotone cache counters (gauges live in HotRowCache/Store state).
struct Counters {
  std::atomic<int64_t> hits{0};
  std::atomic<int64_t> hit_bytes{0};
  std::atomic<int64_t> misses{0};
  std::atomic<int64_t> miss_bytes{0};
  std::atomic<int64_t> fills{0};
  std::atomic<int64_t> fill_bytes{0};
  std::atomic<int64_t> fill_failures{0};
  std::atomic<int64_t> evictions{0};
  std::atomic<int64_t> evicted_bytes{0};
  std::atomic<int64_t> over_budget{0};
  std::atomic<int64_t> prefetches{0};
};

class HotRowCache {
 public:
  // max_bytes >= 0 sets the budget (0 disables; the CALLER evicts —
  // eviction releases tenant quota the cache cannot see); < 0 keeps.
  void Configure(int64_t max_bytes);
  bool enabled() const {
    return max_bytes_.load(std::memory_order_relaxed) > 0;
  }
  int64_t max_bytes() const {
    return max_bytes_.load(std::memory_order_relaxed);
  }

  // Reserve budget and register a kFilling entry for (name, window).
  // nullptr when disabled, already present (idempotent re-warm), or
  // over budget (counted) — prefetch is ADVISORY, never an error.
  // `rows` must be sorted unique (the window planner's contract).
  // `tenant`/`quota_charged` arm the entry's tenant-quota release
  // BEFORE it is published in the map — an eviction racing the
  // prefetch must observe a fully-initialized entry, or the charge
  // leaks (quota_live starts true iff quota_charged > 0).
  std::shared_ptr<Entry> Begin(const std::string& name,
                               const int64_t* rows, int64_t n,
                               int64_t row_bytes, int64_t window,
                               const std::string& tenant,
                               int64_t quota_charged);

  // Fill completion: ok -> kReady (servable); !ok -> kFailed, removed
  // from the map, cache budget released (the buffer itself dies with
  // the last shared_ptr — exactly once).
  void Commit(const std::shared_ptr<Entry>& e, bool ok);

  // Serve `nrows` rows starting at global row `row0` of `name` from a
  // ready entry (one memcpy, outside the lock). False = miss (counted)
  // — the caller reads through the normal path.
  bool ServeRun(const std::string& name, int64_t row0, int64_t nrows,
                int64_t row_bytes, char* dst);

  // Remove entries with window == `window` (< 0: every entry).
  // Removed entries append to `out` so the caller can release their
  // tenant-quota charges; returns the count removed.
  int Evict(int64_t window, std::vector<std::shared_ptr<Entry>>* out);

  // Drop every entry of `name` (cache coherence: Update/Rebind/FreeVar
  // call this so a stale RAM copy can never serve post-write reads).
  // Removed entries append to `out` for quota release.
  void DropVar(const std::string& name,
               std::vector<std::shared_ptr<Entry>>* out);

  // Counters + the two cache gauges: [hits, hit_bytes, misses,
  // miss_bytes, fills, fill_bytes, fill_failures, evictions,
  // evicted_bytes, over_budget, prefetches, charged_bytes, entries].
  void Stats(int64_t out[13]) const;

  Counters& counters() { return cnt_; }

 private:
  // Erase `it` from the map and release its cache-budget charge
  // (exactly once — `charged` flips under mu_).
  void RemoveLocked(
      std::map<std::pair<std::string, int64_t>,
               std::shared_ptr<Entry>>::iterator it)
      DDS_REQUIRES(mu_);

  // Leaf mutex: entry registration/removal and the hit lookup only —
  // every memcpy, allocation and syscall runs outside it.
  mutable std::mutex mu_ DDS_NO_BLOCKING;
  std::map<std::pair<std::string, int64_t>, std::shared_ptr<Entry>>
      entries_ DDS_GUARDED_BY(mu_);
  int64_t charged_ DDS_GUARDED_BY(mu_) = 0;
  std::atomic<int64_t> max_bytes_{0};
  mutable Counters cnt_;
};

// Allocate `bytes` backed by an unlinked file under `dir` (mmap
// MAP_SHARED): the pages are page-cache over NVMe — evictable, not
// pinned RAM — and the disk space is reclaimed automatically when the
// mapping (or the process) goes away, so no free-path can leak a file.
// nullptr on any failure (the caller falls back to a RAM allocation).
void* ColdAlloc(const std::string& dir, int64_t bytes);
// Release a ColdAlloc mapping (munmap).
void ColdFree(void* base, int64_t bytes);

}  // namespace tier
}  // namespace dds

#endif  // DDSTORE_TPU_TIER_H_
