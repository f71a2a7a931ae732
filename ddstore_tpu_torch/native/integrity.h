// End-to-end data integrity: per-row checksums for every registered
// shard, verified remote reads, and the background scrub machinery's
// hash primitives.
//
// The store's whole premise is a one-sided remote read — which means
// every byte delivered to training is trusted blindly: nothing on the
// wire frame, the CMA/process_vm_readv leg, or the /dev/shm mapping it
// came from would notice a flipped bit. The transient-retry ladder guards
// against LOST bytes and replica failover against DEAD peers
// (replica failover); this layer closes the third failure class —
// WRONG bytes — with the verify → retry → failover → kErrCorrupt
// ladder (see store.h).
//
// Checksum design: one 64-bit xxhash-style sum per ROW, salted by the
// row's owner-local index (a right-bytes-wrong-row serve must fail
// verification too) and by a shared seed (DDSTORE_VERIFY_SEED). Every
// read the store issues is row-aligned (runs of whole rows), so
// per-row granularity verifies every remote leg exactly — no
// block-alignment read amplification; the memory cost is 8 bytes/row
// (documented in README "Failure semantics"). The sum table is
// versioned by VarInfo.update_seq and served over the control plane
// (kOpRowSums on the PingConn — never a data lane, never a
// fault-injector draw).

#ifndef DDSTORE_TPU_INTEGRITY_H_
#define DDSTORE_TPU_INTEGRITY_H_

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace dds {
namespace integrity {

// 64-bit xxhash (XXH64) of `n` bytes under `seed`. Implemented locally
// (public-domain algorithm) — the container has no xxhash package and
// the sum format must not depend on one appearing.
uint64_t Hash64(const void* p, size_t n, uint64_t seed);

// The per-row sum: Hash64 of the row bytes, salted by the row's
// OWNER-LOCAL index so a right-bytes-wrong-offset serve fails too.
// Both sides (owner table build, reader verification) must use this
// exact derivation.
uint64_t RowSum(const void* row, int64_t row_bytes, int64_t local_row,
                uint64_t seed);

// Shared seed for every rank's tables (DDSTORE_VERIFY_SEED, default 0).
// Resolved once per process — the seed must agree across ranks, so it
// is env-only by design.
uint64_t SeedFromEnv();

// One shard's sum table: `seq` is the VarInfo.update_seq the sums were
// computed at (-1 = never built), sums[i] covers owner-local row i.
struct SumTable {
  int64_t seq = -1;
  std::vector<uint64_t> sums;
};

// Monotone integrity counters (one set per store; layout mirrored by
// binding.py INTEGRITY_STAT_KEYS via Store::IntegrityCounters).
struct Counters {
  std::atomic<int64_t> sums_computed{0};   // table builds/refreshes
  std::atomic<int64_t> sums_rows{0};       // rows hashed into tables
  std::atomic<int64_t> sums_served{0};     // control-plane sum serves
  std::atomic<int64_t> verified_reads{0};  // remote op lists verified
  std::atomic<int64_t> verified_bytes{0};
  std::atomic<int64_t> mismatches{0};      // raw verification failures
  std::atomic<int64_t> seq_retries{0};     // content-version races:
  //                                          clean transient re-reads
  std::atomic<int64_t> primary_retries{0};  // genuine mismatch -> one
  //                                           primary re-read
  std::atomic<int64_t> verify_failovers{0};  // corrupt primary ->
  //                                            replica chain served
  std::atomic<int64_t> corrupt_errors{0};  // kErrCorrupt surfaced
  std::atomic<int64_t> scrub_rows{0};      // mirror rows scrubbed
  std::atomic<int64_t> scrub_divergent{0};  // mirrors found divergent
  std::atomic<int64_t> scrub_repaired{0};   // divergent mirrors re-pulled
  std::atomic<int64_t> last_corrupt_peer{-1};  // gauge: most recent
  //                                              owner whose bytes
  //                                              failed verification
};

}  // namespace integrity
}  // namespace dds

#endif  // DDSTORE_TPU_INTEGRITY_H_
