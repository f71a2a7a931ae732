// ddstore_tpu native store core.
//
// A distributed, in-memory sample store: each process (TPU-VM host) owns one
// contiguous shard of every registered variable; the global row-index space is
// the concatenation of all shards in rank order; any rank can read any row via
// a one-sided remote read through a pluggable Transport.
//
// Capability parity with the reference store core (see
// reference include/ddstore.hpp:26-258 — variable registry, global index
// construction, one-sided get, epoch fences, teardown) but designed for TPU-VM
// pods: no MPI, byte-oriented rows (dtype lives in the Python binding),
// binary-search owner lookup (the reference scans O(P),
// src/ddstore.cxx:5-17), 64-bit sizes throughout (the reference caps a get at
// <2 GiB via int counts, ddstore.hpp:229-236), and the transport factored out
// behind an interface instead of an `int method` branched at every call site
// (ddstore.hpp:54,125,219,239).

#ifndef DDSTORE_TPU_STORE_H_
#define DDSTORE_TPU_STORE_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "fault.h"
#include "gateway.h"
#include "health.h"
#include "integrity.h"
#include "metrics_hist.h"
#include "thread_annotations.h"
#include "tier.h"

namespace dds {

// Error codes returned by every fallible API. Negative values are errors.
enum ErrorCode : int {
  kOk = 0,
  kErrInvalidArg = -1,   // bad name / shape / range
  kErrNotFound = -2,     // unknown variable
  kErrOutOfRange = -3,   // row range outside the global index space
  kErrCrossShard = -4,   // [start, start+count) spans more than one shard
  kErrEpochState = -5,   // mismatched epoch_begin/epoch_end
  kErrTransport = -6,    // remote read / barrier failed
  kErrExists = -7,       // variable already registered
  kErrNoMem = -8,        // allocation failure
  kErrShapeMismatch = -9,// disp/itemsize disagree across ranks
  kErrPeerLost = -10,    // transient-retry budget exhausted against one
                         // peer: the bounded "owner is gone" signal
                         // (fatal — invoke elastic.recover, do not retry)
  kErrQuota = -11,       // tenant byte/var budget exhausted at
                         // registration: admission refused. Classified
                         // DISTINCTLY from kErrPeerLost — nothing died,
                         // the tenant is over budget (free vars or raise
                         // the quota; retrying is pointless)
  kErrCorrupt = -12,     // data integrity failure (DDSTORE_VERIFY=1):
                         // the delivered bytes disagree with the
                         // owner's published checksums at a STABLE
                         // content version, a primary re-read and every
                         // readable replica holder disagree too. Non-
                         // fatal like kErrQuota — nothing died; the
                         // Python layer names var + rows + peer and the
                         // ddtrace flight recorder dumps automatically
  kErrAdmission = -13    // serving-gateway admission refusal: an
                         // over-share tenant was deferred past its
                         // window (or the rank is draining). Non-fatal
                         // like kErrQuota — nothing died; the response
                         // carries a retry-after hint and clients back
                         // off with seeded jitter and try again.
                         // (-12 is kErrCorrupt; this is the next
                         // free slot.)
};

const char* ErrorString(int code);

// -- tenant namespaces --------------------------------------------------------
//
// A multi-tenant store scopes every non-default tenant's variables as
// "\x02<tenant>\x02<name>" in the ONE native registry, so every
// existing serving leg (local memcpy, CMA, TCP iovec streaming,
// replication mirrors) works on tenant variables unchanged. The default
// tenant "" uses the bare name — the entire pre-tenancy tree is byte-
// and error-code-identical, the same discipline as DDSTORE_REPLICATION=1.
// \x02 cannot appear in a user name that came through the Python layer
// (control characters are rejected there), so scoped names can never
// collide with plain ones, with \x01 mirrors, or with \x03 snapshot
// names.

// The tenant a registry name belongs to ("" = default). Sees through
// the \x01 mirror and \x03 snapshot/kept-version wrappers so serve-side
// accounting attributes mirror pulls and snapshot reads to the tenant
// that owns the underlying data.
std::string TenantOfVarName(const std::string& name);

struct VarInfo {
  std::string name;
  int64_t disp = 0;      // elements per row (flattened sample width)
  int64_t itemsize = 0;  // bytes per element
  int64_t nrows = 0;     // rows in the LOCAL shard
  // Cumulative row counts: cum[r] = total rows owned by ranks 0..r.
  // Global rows [cum[r-1], cum[r]) live on rank r. Size == world.
  std::vector<int64_t> cum;
  char* base = nullptr;  // local shard memory
  bool owned = false;    // true if the store allocated (and must free) base
  // Monotone content version: bumped by every Update() to the LOCAL
  // shard. Mirror holders compare it (one tiny kOpVarSeq control read)
  // before an epoch-fence refresh, so an unchanged shard costs no
  // re-pull. On a MIRROR entry, `mirror_src_seq` instead records the
  // owner's seq the mirror bytes were pulled at (-1 = unknown: always
  // re-pull).
  int64_t update_seq = 0;
  int64_t mirror_src_seq = -1;
  // Bytes reserved against the owning tenant's quota at registration
  // (-1 = none: the ledger was not tracking this namespace at add
  // time). The free paths release exactly this amount, so configuring
  // the default tenant between add and free never releases budget
  // that was never reserved.
  int64_t quota_reserved = -1;
  // Storage tier of the shard's backing: 0 = hot (RAM/shm), 1 = cold
  // (file-backed mmap, NVMe page cache). Set by the Python add_file /
  // spill paths (SetVarTier) — the registry serves both identically;
  // the tier only drives the cold gauges and the placement policy.
  int tier = 0;

  int64_t row_bytes() const { return disp * itemsize; }
  int64_t total_rows() const { return cum.empty() ? 0 : cum.back(); }
  int64_t shard_bytes() const { return nrows * row_bytes(); }
};

// One contiguous read: `nbytes` at byte offset `offset` of the target's
// local shard, into `dst`.
struct ReadOp {
  int64_t offset;
  int64_t nbytes;
  void* dst;
};

// One peer's portion of a batched read (GetBatch partitions its coalesced
// runs by owner and hands the whole set to the transport at once).
struct PeerReadV {
  int target;
  const ReadOp* ops;
  int64_t n;
};

// Cumulative scatter-read planner statistics (GetBatch). All counters are
// monotone since store creation; consumers diff snapshots to get per-epoch
// numbers. `rows` counts requested rows (duplicates included); the unique
// rows actually fetched are `rows - dedup_hits`, so the coalesce ratio is
// (rows - dedup_hits) / runs.
struct PlanStats {
  int64_t batches = 0;        // GetBatch calls planned
  int64_t rows = 0;           // rows requested (incl. duplicates)
  int64_t runs = 0;           // coalesced contiguous runs emitted
  int64_t local_runs = 0;     // runs served by the local shard
  int64_t peer_lists = 0;     // remote per-peer run lists issued (sum of
                              // distinct remote peers over batches)
  int64_t dedup_hits = 0;     // duplicate rows served by replication
  int64_t scratch_runs = 0;   // runs staged through scratch (src-contiguous
                              // but dst-scattered)
  int64_t scratch_bytes = 0;  // bytes staged through scratch
};

// Replicated-read failover accounting. Monotone since store creation;
// consumers diff snapshots for per-epoch views (PipelineMetrics wires
// this in as summary()["failover"]).
struct FailoverStats {
  std::atomic<int64_t> reads{0};          // per-peer op lists rerouted
  std::atomic<int64_t> runs{0};           // ops those lists carried
  std::atomic<int64_t> bytes{0};          // bytes served from replicas
  std::atomic<int64_t> suspect_skips{0};  // reroutes decided by the
  //                                         detector BEFORE any ladder
  //                                         (zero deadline burned)
  std::atomic<int64_t> replica_giveups{0};  // every holder gone ->
  //                                           kErrPeerLost surfaced
  std::atomic<int64_t> mirror_fills{0};     // mirrors (re)filled
  std::atomic<int64_t> mirror_refresh_skipped{0};  // refresh skipped:
  //                                           owner suspected/unreadable
  //                                           (mirror keeps last bytes)
  std::atomic<int64_t> mirror_bytes{0};     // bytes pulled into mirrors
};

class WorkerPool;
// O_DIRECT cold-tier reader (uring_transport.h) — forward-declared:
// store.h cannot include uring_transport.h (it includes tcp_transport.h
// which includes this header). Store only holds a unique_ptr; the
// complete type lives where store.cc includes uring_transport.h.
class ColdDirectReader;

// One-sided read transport. Implementations must be thread-safe: get_batch
// issues reads to distinct peers concurrently.
class Transport {
 public:
  virtual ~Transport() = default;

  // True when the transport classifies and retries transient failures
  // itself (the TCP transport's per-leaf reconnect-and-retry). The Store
  // adds its own bounded retry layer around transports that return false
  // (the in-process transport under fault injection), so every backend
  // gets the same transient/fatal contract without double-retrying.
  virtual bool RetriesInternally() const { return false; }

  // Persistent background workers, when the transport keeps any (the TCP
  // transport's pool). The Store borrows them to overlap its local-copy
  // leg with the remote fan-out — submitted tasks must be flat leaves
  // (never waited on from inside the pool). nullptr = none; callers run
  // inline.
  virtual WorkerPool* worker_pool() { return nullptr; }

  // Read `nbytes` starting at byte offset `offset` within peer `target`'s
  // local shard of variable `name`, into `dst`. Must not require any action
  // from the target's application thread (one-sided semantics; the target's
  // serving thread, if any, is part of the transport).
  virtual int Read(int target, const std::string& name, int64_t offset,
                   int64_t nbytes, void* dst) = 0;

  // Vectored read from one peer. Default loops over Read; transports with a
  // wire protocol override this to pipeline (send all requests, then drain
  // responses) so n small reads cost ~1 round trip, not n.
  virtual int ReadV(int target, const std::string& name, const ReadOp* ops,
                    int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      int rc = Read(target, name, ops[i].offset, ops[i].nbytes, ops[i].dst);
      if (rc != 0) return rc;
    }
    return 0;
  }

  // Batched multi-peer read: every entry's ops go to its target, with
  // whatever concurrency the transport can supply (the TCP transport runs
  // them on a persistent worker pool). Default: sequential ReadV per peer,
  // stopping at the first error. `as_tenant` names the READING tenant
  // for QoS lane budgets ("" = derive from the variable name) — a named
  // tenant streaming the shared default namespace must burn its OWN
  // lane budget, exactly like the async admission gate.
  virtual int ReadVMulti(const std::string& name, const PeerReadV* reqs,
                         int64_t nreqs,
                         const std::string& as_tenant = std::string()) {
    (void)as_tenant;  // lane budgets are a TCP-transport concern
    for (int64_t i = 0; i < nreqs; ++i) {
      int rc = ReadV(reqs[i].target, name, reqs[i].ops, reqs[i].n);
      if (rc != 0) return rc;
    }
    return 0;
  }

  // Shard-memory allocation hooks. The Store routes every owned
  // allocation (Add with copy, Init's zero-fill) through its transport so
  // a transport with a same-host fast path can place shards in shareable
  // memory: the TCP transport backs them with /dev/shm files that peers
  // mmap once and then gather from with plain memcpy — the scatter-read
  // fast path that removes per-segment process_vm_readv overhead
  // entirely. Default: plain malloc/free (the in-process transport needs
  // nothing more). FreeShard must accept any pointer AllocShard returned.
  virtual void* AllocShard(const std::string& name, int64_t nbytes) {
    (void)name;
    return ::malloc(nbytes > 0 ? static_cast<size_t>(nbytes) : 1);
  }
  virtual void FreeShard(const std::string& name, void* base) {
    (void)name;
    ::free(base);
  }

  // Variable-lifecycle hooks, called by the Store UNDER its exclusive
  // lock whenever a shard's backing memory appears, changes, or goes
  // away. Transports with a zero-copy fast path (the CMA/process_vm_readv
  // path) publish {base, len} to same-host readers here; the default is
  // a no-op. Publish must be seqlock-atomic against concurrent remote
  // readers; between Unpublish and the next Publish remote readers must
  // degrade to the transport's ordinary (lock-serialized) path.
  virtual void PublishVar(const std::string& name, const void* base,
                          int64_t nbytes) {}
  virtual void UnpublishVar(const std::string& name) {}

  // Per-transport retry-deadline override (<= 0 clears): transports
  // with an internal retry layer (TCP leaves) apply it to their own
  // RetryTransientLoop calls. Default no-op for transports the
  // Store-level layer covers.
  virtual void SetRetryDeadline(double seconds) { (void)seconds; }

  // -- control-plane liveness hooks ---------------------------------------

  // One heartbeat probe of `target`, bounded by `timeout_ms`. MUST NOT
  // ride the data path (no fault-injector draws — seeded chaos
  // schedules stay identical with the detector on or off) and must not
  // contend with data lanes (a lane mutex held across a long striped
  // read would read as a dead peer). `true` when the peer answered OR
  // when liveness is not yet decidable (endpoints not exchanged) — the
  // detector must not raise suspects during bootstrap.
  virtual bool Ping(int target, long timeout_ms) {
    (void)target;
    (void)timeout_ms;
    return true;
  }

  // The most recent peer a retry layer failed against (-1 = none). The
  // failover layer uses it to name the dead member of a multi-peer
  // batched read (a self-retrying transport tracks its own leaf stats;
  // others are covered by the Store-level layer's counter).
  virtual int last_failed_peer() const { return -1; }

  // Content-version probe of `target`'s shard of `name` (the mirror
  // refresh's cheap "anything new?" check). -1 = unknown/unsupported —
  // the caller must then refresh unconditionally (the safe default).
  // Control plane: like Ping, never a fault-injector draw.
  virtual int64_t ReadVarSeq(int target, const std::string& name) {
    (void)target;
    (void)name;
    return -1;
  }

  // Integrity control op: fetch `count` per-row checksums of `target`'s
  // shard of `name` starting at owner-local row `row0`, plus the
  // content version (`seq`) the table was computed at. Rides the same
  // dedicated control channel as Ping/ReadVarSeq — never a data lane,
  // never a fault-injector draw (seeded chaos schedules are identical
  // with verification on or off on the CONTROL side; the verified
  // DATA re-reads do consume draws, which is why DDSTORE_VERIFY=0 is
  // the pinned-identical default). Default: unsupported.
  virtual int ReadRowSums(int target, const std::string& name,
                          int64_t row0, int64_t count, int64_t* seq,
                          uint64_t* sums) {
    (void)target;
    (void)name;
    (void)row0;
    (void)count;
    (void)seq;
    (void)sums;
    return kErrTransport;
  }

  // ddmetrics control op: pull `target`'s live histogram snapshot
  // (packed metrics::CellRecords) into `out`. Rides the same dedicated
  // control channel as Ping/ReadVarSeq/ReadRowSums — never a data
  // lane, never a DATA-plane fault-injector draw (the ctrl arm
  // injects server-side and the bounded control-retry ladder absorbs
  // it, like every other request/response control op). Returns the
  // bytes written or a negative ErrorCode. Default: unsupported.
  virtual int64_t ReadMetrics(int target, void* out, int64_t cap) {
    (void)target;
    (void)out;
    (void)cap;
    return kErrTransport;
  }

  // Snapshot-epoch control op: ask `target`'s store to pin (or release)
  // snapshot `snap_id` (see Store::SnapshotAcquire). Control plane like
  // Ping/ReadVarSeq — never a data lane, never a fault-injector draw.
  // `tenant` is the acquiring handle's tenant label (per-tenant
  // snapshot-pin accounting on the owner). Default: unsupported.
  virtual int SnapshotControl(int target, int64_t snap_id, bool pin,
                              const std::string& tenant) {
    (void)target;
    (void)snap_id;
    (void)pin;
    (void)tenant;
    return kErrTransport;
  }

  // Serving-gateway session control op against `target`'s store.
  // verb 0 = attach (`tenant` labels the session, `arg` != 0 pins a
  // snapshot, `arg2` reserves quota bytes; the minted session token
  // lands in *token_out), verb 1 = lease renew (`arg` = token),
  // verb 2 = detach (`arg` = token). Control plane like
  // Ping/ReadVarSeq — rides the dedicated control connection, never a
  // data lane, never a DATA-plane fault-injector draw. Default:
  // unsupported.
  virtual int GatewayControl(int target, int verb,
                             const std::string& tenant, int64_t arg,
                             int64_t arg2, int64_t* token_out) {
    (void)target;
    (void)verb;
    (void)tenant;
    (void)arg;
    (void)arg2;
    (void)token_out;
    return kErrTransport;
  }

  // Per-tenant QoS lane-budget knob (the gateway arms a share on a
  // tenant's first live session and clears it on the last). Default:
  // accepted no-op — transports without lane pools have nothing to
  // budget.
  virtual int SetTenantLaneBudget(const std::string& tenant, int lanes) {
    (void)tenant;
    (void)lanes;
    return kOk;
  }

  // Stop answering peers: the serving side of the transport goes, its
  // reads of peers stay. The store calls it in teardown before it frees
  // its variables, so that a peer's read in flight finds a closed
  // connection (which its replica router fails over) and never a
  // well-formed "variable not found" from a store half torn down. Default
  // no-op (a transport that serves nothing).
  virtual void StopServing() {}

  // Install the store's suspect oracle: transports with an internal
  // retry layer consult it between attempts so a ladder against a
  // detector-declared-dead peer aborts in O(heartbeat), not
  // O(deadline). Default no-op (the Store-level retry layer consults
  // the oracle itself).
  virtual void SetSuspectOracle(std::function<bool(int)> oracle) {
    (void)oracle;
  }

  // Collective tagged barrier across the group. Every rank must issue the
  // same serialized sequence of Barrier calls (matching is positional —
  // the TCP transport pairs barriers by an internal per-transport
  // collective sequence number, since callers' tags come from independent
  // subsystems and are not globally ordered; the tag itself is carried
  // only for debugging/diagnostics).
  virtual int Barrier(int64_t tag) = 0;

  virtual int rank() const = 0;
  virtual int world() const = 0;
};

class Store {
 public:
  // The store does not own the transport's group membership; rank/world come
  // from the transport.
  explicit Store(std::unique_ptr<Transport> transport);
  ~Store();

  Store(const Store&) = delete;
  Store& operator=(const Store&) = delete;

  int rank() const;
  int world() const;

  // Register a shard. `all_nrows` is the per-rank row-count table (size
  // world), exchanged by the caller (the Python layer allgathers it; the
  // reference does this with MPI_Allgather, ddstore.hpp:75-89). If `copy` the
  // store memcpys the buffer into its own allocation (reference behavior,
  // ddstore.hpp:43-49); otherwise it borrows the caller's buffer, which must
  // outlive the variable (fixes the registration-time memory doubling).
  int Add(const std::string& name, const void* buf, int64_t nrows,
          int64_t disp, int64_t itemsize, const int64_t* all_nrows, bool copy);

  // Register a zero-filled shard for deferred population (reference `init`,
  // ddstore.hpp:110-179).
  int Init(const std::string& name, int64_t nrows, int64_t disp,
           int64_t itemsize, const int64_t* all_nrows);

  // Overwrite `nrows` local rows starting at local row `row_offset`
  // (reference `update`, ddstore.hpp:181-195 — but bounds-checked here).
  int Update(const std::string& name, const void* buf, int64_t nrows,
             int64_t row_offset);

  // Read `count` global rows [start, start+count) into dst. The range must
  // lie within a single rank's shard (kept from the reference,
  // ddstore.hpp:210-214: it keeps every read single-peer; use GetBatch for
  // scattered indices). Local reads short-circuit to memcpy.
  int Get(const std::string& name, void* dst, int64_t start, int64_t count,
          const std::string& as_tenant = std::string());

  // Read n single rows with global indices starts[0..n) into dst (densely
  // packed, n*row_bytes). The scatter-read planner sorts the indices,
  // dedups duplicates (fetched once, replicated into their other output
  // slots afterwards), and coalesces rows that are adjacent in the owner's
  // shard into maximal contiguous runs — a run whose output slots are also
  // contiguous reads straight into dst; otherwise it is staged through a
  // per-call scratch block and scatter-copied out (memcpy is orders of
  // magnitude cheaper than per-segment transport overhead). Per-peer run
  // lists go to the transport in one ReadVMulti, offset-sorted, so the
  // wire/iovec path sees the fewest, largest, most sequential segments the
  // request permits. This is the hot-path fix for the reference's
  // one-blocking-read-per-sample pattern (ddstore.hpp:197-248 called per
  // sample per batch).
  // `as_tenant` names the READING tenant for the per-tenant read
  // ledger and QoS lane budget ("" = derive from the variable name);
  // see GetBatchAsync for why the two differ.
  int GetBatch(const std::string& name, void* dst, const int64_t* starts,
               int64_t n, const std::string& as_tenant = std::string());

  // Snapshot of the cumulative scatter-read planner statistics.
  PlanStats plan_stats() const;

  // Store-level transient-retry counters (engaged only for transports
  // without internal retry; see Transport::RetriesInternally). Layout:
  // [transient, retries, reconnects, backoff_ms, giveups, fatal,
  // last_peer].
  void RetryCounters(int64_t out[7]) const;

  // Override THIS store's transient-retry deadline (seconds; <= 0
  // restores DDSTORE_OP_DEADLINE_S). Applied to the store-level retry
  // layer and forwarded to the transport's internal one — the degraded
  // readahead path shares one deadline budget across a window give-up
  // and its per-batch refetch through this. Per-store by design: other
  // stores in the process keep their full budgets.
  void SetRetryDeadline(double seconds);

  // -- async batched reads ------------------------------------------------
  //
  // The epoch-readahead engine's native leg: issue a GetBatch in the
  // background and poll/wait for completion, so Python can keep the NEXT
  // readahead window's bulk fetch in flight while the current one is
  // consumed. The read runs on a small dedicated pool — NOT the
  // transport's worker pool: GetBatch itself fans its per-peer run lists
  // out over that pool and Wait()s on them, and a waiting task occupying
  // a transport worker could exhaust the thread cap with every worker
  // blocked on leaves that can no longer run.
  //
  // `dst` and `starts`' rows are copied at issue time; `dst` must stay
  // alive (and unread) until the ticket completes. Tickets are released
  // explicitly; Release blocks until the read finishes (there is no
  // mid-flight cancel — a transport read cannot be safely abandoned
  // while the worker may still write into `dst`), which is exactly the
  // teardown barrier loader cancellation needs.

  // Returns a positive ticket, or a negative ErrorCode on invalid args.
  // `as_tenant` names the READING handle for QoS admission and the
  // admitted/deferred ledger ("" = derive from the variable name, the
  // pre-tenancy behavior). The two differ exactly when a named tenant
  // reads the shared default namespace — the headline attach() use
  // case — where deriving from the name would gate the eval reader
  // under the default tenant's share instead of its own.
  int64_t GetBatchAsync(const std::string& name, void* dst,
                        const int64_t* starts, int64_t n,
                        const std::string& as_tenant = std::string());

  // Async vectored run read — the readahead window fast path. The
  // caller (the Python window planner) has already sorted,
  // deduplicated, and coalesced its rows into per-peer runs; this
  // entry executes exactly those runs without re-deriving the plan
  // (O(runs) instead of O(rows) — at window scale, 10^5+ rows in ~4
  // runs, the planner pass otherwise rivals the copy time). Run i
  // reads nbytes[i] at byte offset src_off[i] of targets[i]'s shard
  // into dst + dst_off[i]. Same ticket/waiting contract as
  // GetBatchAsync (including `as_tenant`); all four arrays are copied
  // at issue time.
  int64_t ReadRunsAsync(const std::string& name, void* dst,
                        const int64_t* targets, const int64_t* src_off,
                        const int64_t* dst_off, const int64_t* nbytes,
                        int64_t nruns,
                        const std::string& as_tenant = std::string());
  // 1 = done ok; 0 = still in flight after `timeout_ms` (0 polls,
  // negative waits forever); <0 = the completed read's error, or
  // kErrInvalidArg for an unknown/released ticket. `done_mono_s`, when
  // non-null and the read is done, receives the CLOCK_MONOTONIC
  // completion time (seconds) — comparable to Python's time.monotonic(),
  // the readahead producer-idle accounting.
  int AsyncWait(int64_t ticket, int64_t timeout_ms,
                double* done_mono_s = nullptr);
  // Blocks until the read completes, then frees the ticket. Returns the
  // read's ErrorCode (kErrInvalidArg for an unknown ticket).
  int AsyncRelease(int64_t ticket);
  // Unreleased tickets (in flight or completed-but-held). A clean loader
  // teardown leaves this at 0.
  int64_t AsyncPending() const;

  // Async admission width — how many async batched reads may be RUNNING
  // (contending for the transport's lanes/cores) at once; excess issues
  // queue store-side and start as running ones complete, so the ticket
  // contract is unchanged. This is the cost-model scheduler's "width"
  // knob: n >= 1 overrides, n <= 0 restores the DDSTORE_ASYNC_THREADS /
  // core-ladder default. Takes effect on the next issue/completion (a
  // width raise also pumps the deferred queue immediately).
  int SetAsyncWidth(int n);
  // The width currently admitting (override, env, or ladder default).
  int AsyncWidth() const;

  // -- shard replication + transparent read failover ----------------------
  //
  // DDSTORE_REPLICATION=R (default 1 = exactly the pre-replication
  // behavior, byte- and error-code-identical): each rank additionally
  // hosts read-only MIRRORS of the next R-1 ranks' shards (chain
  // placement), registered as hidden variables (MirrorVarName) and
  // served through every existing path (local memcpy, CMA shm, TCP).
  // Remote reads route to the primary owner; on transient-budget
  // exhaustion or a heartbeat-detector verdict the failed peer's runs
  // replan onto its replica set instead of raising kErrPeerLost — which
  // now fires only when ALL R holders are gone. Mirrors fill at
  // Replicate() (the Python add() calls it post-barrier) and refresh at
  // EpochBegin (picking up Update()s); a suspected owner's refresh is
  // skipped so the mirror keeps its last good bytes — exactly the copy
  // failover needs.

  // The replication factor in force (env, clamped to [1, world]).
  int replication() const { return replication_; }
  // Hidden registry name of this rank's mirror of `owner`'s shard of
  // `name` (exposed for tests).
  static std::string MirrorVarName(const std::string& name, int owner);
  // Replica set of `owner`'s shard, primary first: out[k] =
  // (owner - k) mod world for k in [0, R). Exposed for tests/Python.
  int ReplicaSet(int owner, int* out, int cap) const;
  // Pull/refresh this rank's mirrors of `name` (the shards of ranks
  // rank+1 .. rank+R-1). Collective discipline is the caller's: every
  // owner's shard must be registered before any holder pulls.
  int Replicate(const std::string& name);
  // Re-pull the mirrors this rank hosts, creating missing ones.
  // `force` re-pulls unconditionally (the elastic-recovery rebuild —
  // a replacement's restored shard may have ROLLED BACK to its
  // checkpoint at the same content version); the EpochBegin refresh
  // passes false and skips owners whose update_seq matches the last
  // pull (a static dataset's fence costs one tiny control read per
  // mirror, not a whole-shard pull). Suspected/unreachable owners are
  // skipped either way, never fatal.
  void RefreshMirrors(bool force = true);

  // Content version of the LOCAL shard (served to mirror holders over
  // the transport's kOpVarSeq control op). -1 if unknown.
  int64_t UpdateSeqOf(const std::string& name) const;

  // Peer-liveness view: the union of heartbeat verdicts and data-path
  // ladder give-ups. ClearPeerSuspected is the elastic-recovery hook
  // (the replacement process at this rank gets a clean slate).
  bool PeerSuspected(int target) const;
  void MarkPeerSuspected(int target);
  void ClearPeerSuspected(int target);
  // Writes min(world, cap) 0/1 suspicion flags; returns count written.
  int HealthState(int64_t* out, int cap) const;
  // Start/stop the heartbeat thread at runtime (interval_ms <= 0
  // stops; suspect_n <= 0 keeps the env/default).
  void ConfigureHeartbeat(long interval_ms, int suspect_n);

  // Failover/heartbeat observability. Layout (keep in sync with
  // binding.py FAILOVER_STAT_KEYS): [replication, failover_reads,
  // failover_runs, failover_bytes, suspect_skips, replica_giveups,
  // mirror_fills, mirror_refresh_skipped, mirror_bytes, hb_pings,
  // hb_failures, hb_suspects_raised, hb_active, suspected_now].
  void FailoverCounters(int64_t out[16]) const;

  // -- end-to-end data integrity -------------------------------------------
  //
  // Per-row 64-bit checksums (integrity.h) computed at Add/Init/Update/
  // Rebind and served over the control plane; under DDSTORE_VERIFY=1
  // readers checksum every remote leg's landed bytes against the
  // owner's table under the served content version. A concurrent
  // Update mid-read is a clean transient retry (the table refetches at
  // the new seq); a genuine mismatch retries the primary once, then
  // reroutes onto the replica chain, and only when every readable
  // holder disagrees with the published sums does kErrCorrupt surface.
  // DDSTORE_VERIFY=0 (the default) leaves the whole tree byte-,
  // error-code- and seeded-fault-counter-identical: no sums are
  // computed, no control reads issued, no draws consumed.

  // Reader-side verification in force?
  bool verify_mode() const {
    return verify_.load(std::memory_order_relaxed);
  }
  // Runtime toggles (tests/benches script without env plumbing):
  // verify -1 keeps / 0 off / 1 on (also enables sum computation);
  // scrub_ms -1 keeps / 0 stops the scrubber / >0 (re)starts it at
  // that per-mirror tick interval.
  int ConfigureIntegrity(int verify, long scrub_ms);
  // Owner-side sum serve (also the transport's kOpRowSums entry and a
  // test hook): writes `count` sums of the LOCAL shard of `name`
  // starting at local row `row0` plus the content version they were
  // computed at. Builds the table lazily (integrity must be enabled).
  int RowSums(const std::string& name, int64_t row0, int64_t count,
              uint64_t* out, int64_t* seq_out);
  // One synchronous scrub pass over every resident mirror (the
  // deterministic test/bench hook; the background thread does the same
  // one mirror per tick). Returns the number of divergent mirrors
  // found (repairs counted separately), or a negative ErrorCode.
  int ScrubOnce();
  // Integrity observability. Layout (keep in sync with binding.py
  // INTEGRITY_STAT_KEYS): [verify_mode, sums_tables, sums_computed,
  // sums_rows, sums_served, verified_reads, verified_bytes,
  // verify_mismatches, verify_seq_retries, verify_primary_retries,
  // verify_failovers, corrupt_errors, scrub_rows, scrub_divergent,
  // scrub_repaired, last_corrupt_peer].
  void IntegrityStats(int64_t out[16]) const;

  // -- tiered storage: hot-row cache + cold placement ----------------------
  //
  // DDSTORE_TIER_CACHE_BYTES > 0 arms a bounded RAM cache of row
  // ranges (tier::HotRowCache). The readahead engine warms it with
  // upcoming windows' row lists (CachePrefetch — an async, detached,
  // quota-charged fill through the normal batched-read path) and every
  // top-level read (Get/GetBatch/ReadRuns) consults it run-by-run, so
  // a warmed window's delivery is an in-RAM gather while the NEXT
  // window's cold rows stream in behind it. Disabled (the default) the
  // whole tree is byte-, error-code- and seeded-fault-counter-
  // identical to the pre-tiering store. DDSTORE_TIER_COLD_DIR +
  // DDSTORE_TIER_PLACEMENT additionally let mirror fills and snapshot
  // kept copies LAND COLD (file-backed mmap) per tenant policy — a
  // replica chain or snapshot epoch no longer has to pin RAM.

  // Runtime cache budget (bytes; 0 disables and evicts, < 0 keeps).
  int ConfigureTierCache(int64_t max_bytes);
  // Record the tier of a registered variable's backing (0 hot, 1
  // cold); drives the cold_vars/cold_bytes gauges only.
  int SetVarTier(const std::string& name, int tier);
  // The recorded tier, or a negative ErrorCode.
  int VarTier(const std::string& name) const;
  // Placement policy for `tenant`'s mirror fills and kept copies:
  // 1 = cold (file-backed under DDSTORE_TIER_COLD_DIR), 0 = hot.
  int SetTierPlacement(const std::string& tenant, int cold);
  // Register the backing file of a READONLY cold (tier-1) var so local
  // reads of it are served via O_DIRECT through the shared submission
  // ring (ColdDirectReader, uring_transport.h) instead of faulting the
  // mmap. Only safe for vars that are never updated after registration:
  // O_DIRECT bypasses the page cache, so a write through the mmap would
  // be invisible to subsequent direct reads. Returns kErrNotFound for
  // an unknown var, kErrInvalidArg for a hot (tier-0) var, and
  // kErrTransport when io_uring/O_DIRECT is unavailable (the var then
  // simply stays on the mmap path — the caller logs, never fails).
  int SetVarFile(const std::string& name, const std::string& path);
  // ColdDirectReader observability: [files, reads, bytes, fallbacks,
  // regbuf, ring_ok] (zeros when no var was ever registered).
  void ColdDirectStats(int64_t out[6]) const;
  // Warm the cache with `n` sorted-unique global rows of `name` as
  // window `window` (the eviction key). Advisory: over-budget /
  // duplicate / disabled-cache calls return kOk and do nothing. The
  // fill runs detached on the async pool (admission-gated, tenant-
  // accounted, ticket auto-released on completion) and is charged
  // against the reading tenant's byte quota until eviction.
  int CachePrefetch(const std::string& name, const int64_t* rows,
                    int64_t n, int64_t window,
                    const std::string& as_tenant = std::string());
  // Evict window `window`'s entries (< 0: every entry), releasing
  // their quota charges. Returns the entry count evicted.
  int CacheEvict(int64_t window);
  // Tiering observability. Layout (keep in sync with binding.py
  // TIERING_STAT_KEYS): [cache_max_bytes, cache_bytes, cache_entries,
  // cold_vars, cold_bytes, hits, hit_bytes, misses, miss_bytes,
  // fills, fill_bytes, fill_failures, evictions, evicted_bytes,
  // over_budget, prefetches].
  void TieringStats(int64_t out[16]) const;

  // -- ddmetrics: live latency histograms + SLO monitor ---------------------
  //
  // Always-on (DDSTORE_METRICS, default 1) log2-bucketed latency and
  // bytes histograms per (op class, route, peer, reading tenant),
  // updated at op end with a few relaxed atomic increments — live
  // p50/p90/p99 without tracing (metrics_hist.h). MetricsPull merges
  // in any peer's view over the control plane (kOpMetrics on the
  // dedicated PingConn), so one rank can assemble the CLUSTER latency
  // surface. The SLO monitor evaluates per-tenant latency objectives
  // (DDSTORE_TENANT_SLOS / SetTenantSlos) over per-window deltas of
  // these histograms: a breach emits a kSloBreach trace event, dumps
  // the flight recorder (kReasonSloBreach), and the Python layer
  // fires the scheduler's replan trigger. With no SLOs configured the
  // monitor is INERT — byte-, error-code- and seeded-fault-counter-
  // identical (it reads counters, never the data path).

  metrics::Registry& metrics_registry() { return metrics_; }
  // Runtime switch (-1 keeps); DDSTORE_METRICS is the load-time knob.
  int ConfigureMetrics(int enabled) { return metrics_.Configure(enabled); }
  bool MetricsEnabled() const { return metrics_.enabled(); }
  void MetricsReset() { metrics_.Reset(); }
  // Serialize THIS store's cells (metrics::CellRecord packed array).
  // out == nullptr returns the worst-case byte size.
  int64_t MetricsSnapshot(void* out, int64_t cap) const {
    return metrics_.Snapshot(out, cap);
  }
  // Pull `target`'s snapshot over the control plane. target == rank()
  // serves locally; a detector-suspected peer short-circuits to
  // kErrPeerLost with zero control budget burned (never a giveup —
  // cluster views must assemble around a corpse, not stall on it).
  int64_t MetricsPull(int target, void* out, int64_t cap);
  // Test / Python-side injection hook (bucket-math units, synthetic
  // exporter fixtures). Interns `tenant` on first sight;
  // kErrInvalidArg on an out-of-range class/route/peer.
  int MetricsRecord(int cls, int route, int peer,
                    const std::string& tenant, uint64_t lat_ns,
                    uint64_t bytes);
  void MetricsStats(int64_t out[metrics::kNumStats]) const {
    metrics_.Stats(out);
  }

  // Replace the tenant latency objectives: "t=p99:5ms,t2=p50:200us"
  // (a bare "p99:5ms" entry names the default tenant; units
  // ns/us/ms/s; one entry per (tenant, percentile)). Baselines reset
  // to the current histograms, so the first window starts clean.
  // Empty spec clears. kErrInvalidArg when nothing parseable remains
  // of a non-empty spec.
  int SetTenantSlos(const std::string& spec);
  // Evaluate every objective over the histogram delta since the last
  // evaluation. Rate-limited by DDSTORE_SLO_WINDOW_MS (a call inside
  // the window returns 0 rows and keeps the running window intact).
  // Breaches are written as rows of 6 int64s [tenant_slot, pct,
  // threshold_ns, measured_low_ns, window_count, 0] (bounded by
  // cap_rows); a breach is declared only when the p-quantile's WHOLE
  // log2 bucket lies above the objective — provable, never a
  // bucketing artifact. Each breach emits kSloBreach and one flight
  // dump (kReasonSloBreach). Returns the breach row count.
  int EvaluateSlos(int64_t* out, int cap_rows);
  // [rules, evaluations, breaches, window_ms, last_breach_tenant_slot,
  // 0, 0, 0] — keep in sync with binding.py SLO_STAT_KEYS.
  void SloStats(int64_t out[8]) const;

  // -- tenant quotas, shares, accounting ----------------------------------
  //
  // Per-tenant admission control: a byte/var budget checked atomically
  // at add/init registration (kErrQuota on exhaustion — a distinct,
  // non-fatal class), a weighted async-admission share so one tenant's
  // readahead cannot starve another's scatter reads (built on the async
  // admission gate), and a per-tenant ledger (bytes, reads, serves,
  // admissions, deferrals, rejections, snapshot pins) surfaced through
  // summary()["tenants"]. All of it is inert — zero locks, zero
  // branches beyond one first-byte check — until a tenant is
  // configured or a scoped name appears.

  // Byte/var budget for `tenant` (< 0 = unlimited). Checked-and-reserved
  // atomically at registration; Free returns the budget.
  int SetTenantQuota(const std::string& tenant, int64_t max_bytes,
                     int64_t max_vars);
  // Async-admission weight (>= 1). With any share configured, tenant t
  // may have at most max(1, width * share_t / total_shares) async
  // batched reads RUNNING at once; excess defers (never rejected) and
  // admits as slots free. No shares configured = no per-tenant gate,
  // exactly the pre-tenancy admission.
  int SetTenantShare(const std::string& tenant, int share);
  // CSV of every tenant the store has seen (config or traffic).
  int TenantNames(char* out, int cap) const;
  // Ledger snapshot for one tenant. Layout (keep in sync with
  // binding.py TENANT_STAT_KEYS): [quota_bytes, quota_vars, bytes,
  // vars, quota_rejections, read_bytes, reads, served_bytes,
  // served_reads, async_admitted, async_deferred, snapshot_pins,
  // share]. quota_*/bytes/vars/share/snapshot_pins are gauges; share
  // reports 0 when no share was configured for the tenant (the gate
  // then grants it implicit weight 1 against the configured total).
  int TenantCounters(const std::string& tenant, int64_t out[16]) const;
  // Serve-side accounting hook (the transport's serving loop calls it
  // after streaming a response): attributes `nbytes` of served reads
  // to the tenant that owns `name`. Cheap no-op for unscoped names
  // unless the default tenant was explicitly configured.
  void AccountTenantServe(const std::string& name, int64_t nbytes);

  // -- read-only snapshot epochs ------------------------------------------
  //
  // A reader pins the CURRENT content version of every shard
  // (SnapshotAcquire: local pin + a control op to every peer) and then
  // reads through snapshot-scoped names ("\x03s\x03<id>\x03<name>",
  // built by the Python layer). The paper's `update` path becomes a
  // safe ONLINE write API: Update() on a var whose current version a
  // snapshot pins first copies the old shard bytes into a hidden
  // kept-version variable ("\x03k\x03<seq>\x03<name>",
  // copy-on-publish, updated shards only), then overwrites — the
  // owner resolves each snapshot read to the primary (version
  // unchanged) or the kept copy under ONE registry-lock acquisition,
  // so a snapshot reader is byte-stable across a concurrent writer's
  // update + epoch fence. The kept copy is reclaimed when the last
  // snapshot pinning that version releases.

  // Pin the store-wide current versions; returns a positive snapshot
  // id, or a negative ErrorCode (a peer that cannot be pinned fails
  // the acquire and already-placed pins are rolled back). `tenant`
  // labels the acquiring handle for per-tenant pin accounting.
  int64_t SnapshotAcquire(const std::string& tenant);
  // Release a snapshot everywhere; kept versions whose last pin this
  // was are freed (peers best-effort: a dead peer's pins die with it).
  int SnapshotRelease(int64_t snap_id);
  // Owner-side halves (also the transport's control-op entry points).
  int PinSnapshot(int64_t snap_id, const std::string& tenant);
  int UnpinSnapshot(int64_t snap_id);
  // [active_snapshots, kept_versions, kept_bytes, reclaimed_pins] on
  // THIS rank (reclaimed_pins counts pins released by the stale-pin
  // reaper: TTL-expired or dead-owner, see GatewayReap).
  void SnapshotCounters(int64_t out[4]) const;
  // Snapshot-scoped registry name (exposed for the Python layer/tests).
  static std::string SnapVarName(int64_t snap_id, const std::string& name);
  static std::string KeepVarName(int64_t seq, const std::string& name);

  // -- serving gateway (gateway.h) -------------------------------------------
  //
  // Ephemeral-reader session multiplexing + histogram-driven admission
  // control. Default OFF (DDSTORE_GATEWAY=0): no thread, no lock, one
  // relaxed load per read op — byte-identical to the pre-gateway tree.

  // Runtime (re)configure; -1 keeps each numeric field. enabled >= 1
  // clears a previous drain; pin_ttl_ms / enabled also (re)arm the
  // background lease/pin reaper (scrub-pattern lifecycle).
  int ConfigureGateway(int enabled, long lease_ms, long defer_ms,
                       int queue_cap, int admit_margin_pct,
                       int lane_share, long pin_ttl_ms);
  // Local session lifecycle (also the transport's kOpAttach/kOpDetach/
  // kOpLease serve entry points). Attach reserves `quota_bytes`
  // against the tenant budget, optionally pins a snapshot, and arms
  // the tenant's lane-budget share on its FIRST live session; returns
  // a positive token or a negative ErrorCode.
  int64_t GatewayAttach(const std::string& tenant, int with_snapshot,
                        int64_t quota_bytes);
  int GatewayRenew(int64_t token);
  // Detach releases everything the lease held (snapshot pins via the
  // UnpinSnapshot path, quota reservation, lane share when last-of-
  // tenant). Lease expiry runs the exact same release.
  int GatewayDetach(int64_t token);
  // Remote flavors (target == rank() or target < 0 degrade to local).
  int64_t GatewayAttachTo(int target, const std::string& tenant,
                          int with_snapshot, int64_t quota_bytes);
  int GatewayRenewTo(int target, int64_t token);
  int GatewayDetachTo(int target, int64_t token);
  // Graceful drain: stop admitting, wait up to deadline_ms for
  // in-flight reads, shed the rest with kErrAdmission. Wired into
  // elastic recovery so a leaving rank drains instead of RSTing.
  int GatewayDrain(long deadline_ms);
  // One synchronous reap pass (the background reaper runs this same
  // body): expire leases + release what they held, then reclaim stale
  // snapshot pins — TTL-expired (DDSTORE_SNAP_PIN_TTL_MS) or pinned
  // by a suspected-dead owner rank — via UnpinSnapshot. Pins held by
  // a LIVE gateway lease are exempt (the lease is their liveness).
  // Returns the number of pins reclaimed.
  int GatewayReap();
  void GatewayStats(int64_t out[gw::kGwStatSlots]) const;

  // Metadata query: total rows across all ranks (reference `query`,
  // src/ddstore.cxx:46-49) plus shape info.
  int Query(const std::string& name, int64_t* total_rows, int64_t* disp,
            int64_t* itemsize, int64_t* local_rows) const;

  // Epoch fences: collective tagged barrier + memory-visibility point per
  // batch (reference semantics: MPI_Win_fence over every variable,
  // src/ddstore.cxx:51-77, with a fence_active state machine that throws on
  // double begin/end :57-58,71-72). `collective`=false makes them local
  // no-op state transitions (the reference's method-1 behavior).
  int EpochBegin();
  int EpochEnd();
  void set_epoch_collective(bool collective) { epoch_collective_ = collective; }
  // Elastic-recovery fence realignment: force the fence state machine
  // CLOSED (idempotent, local). An aborted collective fence rolls
  // itself back on every rank that ABORTED, but a fence abort need not
  // be unanimous — a victim that died after partially disseminating
  // its notifies can let some survivors complete the fence while
  // others roll back, leaving fence_active_ divergent across the
  // group. recover()/rejoin() call this on every rank so the group
  // re-enters its first post-recovery epoch from one agreed state.
  void FenceReset();

  // Atomically swap the LOCAL shard's backing memory to `base` (same byte
  // length, already holding identical contents), freeing the old buffer if
  // the store owned it. Runs under the exclusive lock, so concurrent
  // readers and serving threads see either the old or the new backing,
  // never a gap — this is how spill_to_disk moves a shard RAM->mmap while
  // remote readers stay live (the free+re-add alternative has a window
  // where remote reads return kErrNotFound). The new backing is borrowed:
  // the caller keeps it alive for the variable's lifetime.
  int Rebind(const std::string& name, void* base);

  // Drop one variable (MPI_Win_free analogue, src/ddstore.cxx:79-96).
  int FreeVar(const std::string& name);
  // Drop everything.
  int FreeAll();

  // Direct barrier for the Python layer.
  int Barrier(int64_t tag);

  // Returns base pointer of the local shard (for zero-copy serving / tests),
  // nullptr if unknown.
  char* LocalBase(const std::string& name) const;

  // Owner lookup: index of the rank owning global row `row`, via binary
  // search over the cumulative table. Exposed for tests.
  static int OwnerOf(const std::vector<int64_t>& cum, int64_t row);

  // Snapshot of variable metadata (for the serving thread).
  bool GetVarInfo(const std::string& name, VarInfo* out) const;

  // Copy `nbytes` at byte offset `offset` of the LOCAL shard of `name` into
  // dst, holding the read lock across the copy — the only safe way for
  // transports/serving threads to touch shard memory (a metadata snapshot's
  // base pointer could be freed by a concurrent FreeVar).
  int ReadLocal(const std::string& name, int64_t offset, int64_t nbytes,
                void* dst) const;

  // Vectored ReadLocal: one lock acquisition + one registry lookup for n
  // copies. The batched-read hot path serves hundreds of per-row local
  // runs per call; per-run locking dominates otherwise.
  int ReadLocalV(const std::string& name, const ReadOp* ops,
                 int64_t n) const;

  // Run `fn(base, shard_bytes)` on the LOCAL shard under the shared lock
  // — the zero-intermediate-copy serving path: the TCP server streams
  // response bytes straight out of shard memory inside `fn` instead of
  // memcpying them into a scratch buffer first. `fn`'s return value is
  // passed through; kErrNotFound if the variable is unknown. `fn` must be
  // bounded (the lock blocks Update/Rebind/FreeVar for its duration).
  int WithShard(const std::string& name,
                const std::function<int(const char*, int64_t)>& fn) const;

 private:
  int AddInternal(const std::string& name, const void* buf, int64_t nrows,
                  int64_t disp, int64_t itemsize, const int64_t* all_nrows,
                  bool copy, bool zero_fill);

  // -- tiering internals ---------------------------------------------------

  // The real GetBatch body. `use_cache` = false is the cache FILL's
  // entry (a fill re-consulting the cache would serve itself).
  int GetBatchImpl(const std::string& name, void* dst,
                   const int64_t* starts, int64_t n,
                   const std::string& as_tenant, bool use_cache);
  // Try to serve one planned run ([offset, offset+nbytes) of
  // `target`'s shard of `name`) from the hot cache. Only row-aligned
  // runs are servable; a hit is one memcpy + a trace event.
  bool TierServe(const std::string& name, const VarInfo& v, int target,
                 int64_t offset, int64_t nbytes, void* dst);
  // Fill completion: commit/remove the entry, release its tenant-quota
  // charge on failure, emit the kCacheFill trace event.
  void FinishCacheFill(const std::shared_ptr<tier::Entry>& e, int rc);
  // Release evicted/dropped entries' tenant-quota charges (each
  // exactly once via the entry's quota_live exchange).
  void ReleaseTierQuota(
      const std::vector<std::shared_ptr<tier::Entry>>& gone);
  // Bytes-only tenant-quota charge for cache entries (no var count,
  // no kErrQuota classification — prefetch is advisory). True when
  // charged OR the tenant is untracked (nothing to charge).
  bool TenantReserveBytes(const std::string& tenant, int64_t bytes,
                          bool* charged);
  void TenantReleaseBytes(const std::string& tenant, int64_t bytes);
  // Cold placement: true when `name`'s owning tenant's policy says
  // mirror/kept allocations land on the cold tier (and a cold dir is
  // configured).
  bool ColdPlacementFor(const std::string& name) const;
  // Allocate a shard backing honoring the placement policy: a cold
  // file mapping when policy says so (tracked in cold_maps_), else
  // the transport's AllocShard. FreeOwnedShard is the matching free.
  char* AllocPlacedShard(const std::string& name, int64_t bytes);
  void FreeOwnedShard(const std::string& name, void* base);

  // Bounded transient-retry wrapper around one transport call (Get's
  // single read, GetBatch/ReadRuns' ReadVMulti). No-op passthrough when
  // the transport retries internally. `target` names the peer for the
  // last_peer diagnostic; -1 = multi-peer/unknown.
  int RetryTransient(const std::function<int()>& call, int target);

  // The remote leg of GetBatch/ReadRuns: with replication off this IS
  // the old single retried ReadVMulti; with R > 1 it partitions out
  // suspected peers (replica-routed with zero deadline burn), issues
  // the rest, and on a kErrPeerLost verdict marks the named peer
  // suspected and replans ITS ops onto the replica set — iterating
  // until everything landed or a row's whole replica set is gone.
  int RemoteRead(const std::string& name,
                 const std::map<int, std::vector<ReadOp>>& by_peer,
                 const std::string& as_tenant = std::string());
  // Serve `owner`'s ops from its replica chain (local mirror memcpy or
  // a remote read of the holder's mirror variable). kErrPeerLost when
  // every holder is gone or mirrorless. `verify_bytes` is the
  // CORRUPTION reroute (a live primary whose bytes failed
  // verification): each holder's landed bytes are checksummed against
  // the owner's published table and a disagreeing holder is skipped —
  // kErrCorrupt when every readable holder disagrees. The DEAD-owner
  // path keeps verify_bytes=false: a mirror deliberately serves the
  // last good (possibly pre-fence) bytes, which current-version sums
  // would wrongly reject.
  int ReadViaReplica(const std::string& name, int owner,
                     const std::vector<ReadOp>& ops,
                     bool verify_bytes = false);
  // (Re)register + pull this rank's mirror of `owner`'s shard of
  // `name`, recording `src_seq` as the content version pulled.
  // Chunked row-aligned: transport-read into scratch, then copy under
  // the exclusive lock (concurrent failover readers see every row
  // either old or new — never torn, never a data race).
  int FillMirror(const std::string& name, int owner, const VarInfo& v,
                 int64_t src_seq);
  // The peer the most recent retry-layer failure named (-1 unknown).
  int LastFailedPeer() const;

  // Shared tail of every failed collective (barrier / epoch fence):
  // when the transport's detector abort classified kErrPeerLost, pull
  // the named peer out of the transport, mark it suspected (the same
  // registry data-path verdicts feed, so subsequent reads fail over /
  // short-circuit immediately) and record it in the store-level retry
  // stats so the Python layer's classify names the dead member
  // uniformly across backends.
  void NoteCollectiveFailure(int rc);

  // -- integrity internals -------------------------------------------------

  // Build/refresh the LOCAL shard's sum table if stale (lazy: first
  // serve after an enable, or after Update dropped a stale table).
  // Takes the shared registry lock itself — never call under mu_.
  int EnsureOwnSums(const std::string& name);
  // Cached fetch of `owner`'s sum table for `name` over the control
  // plane (`refresh` forces a refetch). `rows` is the owner's shard
  // row count (from the cum table). False when unavailable (owner
  // down, integrity off there, unknown var).
  bool EnsureSumTable(int owner, const std::string& name, int64_t rows,
                      std::shared_ptr<const integrity::SumTable>* out,
                      bool refresh);
  int64_t CachedSumSeq(int owner, const std::string& name) const;
  void InvalidateSumCache(int owner, const std::string& name);
  // FreeVar/FreeAll: drop the own table AND every reader-cache entry
  // of `name` (free is collective — a re-add restarts at seq 0, and a
  // stale cached table at the same seq would read as corruption).
  void DropSumsFor(const std::string& name);
  // Compare `n` landed ops (read from `owner`'s shard of `name`)
  // against the owner's published sums. kOk = verified;
  // kErrCorrupt = mismatch (first bad owner-local row in *bad_row);
  // kErrNotFound = unverifiable (no table / non-row-aligned) — the
  // caller treats that as a pass, never an error.
  int VerifyOps(const std::string& name, int owner, const ReadOp* ops,
                int64_t n, int64_t* bad_row);
  // The verify → transient-retry → primary-retry → replica →
  // kErrCorrupt ladder, run after a SUCCESSFUL primary read. `reread`
  // re-executes that read (already transport-retried). kOk when the
  // delivered bytes end up verified (possibly re-read or served from a
  // replica); kErrCorrupt when every readable holder disagrees with
  // the published sums.
  int VerifyAfterRead(const std::string& name, int owner,
                      const ReadOp* ops, int64_t n,
                      const std::function<int()>& reread);
  // Scrub machinery: one mirror per call (`base`/`owner` parsed from
  // the mirror name by the caller); returns 1 if divergent, 0 clean /
  // skipped, negative on error.
  int ScrubMirror(const std::string& mname, const std::string& base,
                  int owner);
  void ConfigureScrub(long interval_ms);
  void StopScrub();
  // The join half, serialized by scrub_cfg_mu_ (two concurrent
  // configures must never assign over a joinable thread —
  // std::terminate).
  void StopScrubLocked() DDS_REQUIRES(scrub_cfg_mu_);
  void ScrubLoop();

  // Serving-gateway plumbing. GatewayAdmit is the per-read gate
  // (kOk / kErrAdmission); GatewayPressure is the histogram + queue-
  // depth predicate passed into gw::Gateway::Admit (re-evaluated on
  // completion wakeups); ReleaseGwSession releases what an expired or
  // detached lease held. The reaper reuses the scrub lifecycle.
  int GatewayAdmit(const std::string& name, const std::string& as_tenant);
  bool GatewayPressure();
  void ReleaseGwSession(const gw::SessionInfo& s, bool expired);
  void ConfigureGwReaper(long interval_ms);
  void StopGwReaper();
  void StopGwReaperLocked() DDS_REQUIRES(gw_cfg_mu_);
  void GwReaperLoop();

  // Pin-aware registry resolution, the single point every read-serving
  // leg (ReadLocal/ReadLocalV/WithShard — local memcpy, CMA fallback,
  // TCP streaming alike) goes through: a snapshot-scoped name resolves
  // to the primary while its pinned version is current, else to the
  // kept copy — atomically under the ONE lock acquisition the caller
  // already holds, so a concurrent Update can never tear a snapshot
  // read. Plain names resolve to themselves at zero extra cost.
  std::map<std::string, VarInfo>::const_iterator ResolveDataLocked(
      const std::string& name) const DDS_REQUIRES(mu_);
  // Metadata resolution: a snapshot name's SHAPE (cum table, row bytes)
  // is always the primary's — versions never change geometry — so the
  // reader-side batch planner partitions snapshot reads by owner
  // exactly like primary reads.
  std::map<std::string, VarInfo>::const_iterator ResolveMetaLocked(
      const std::string& name) const DDS_REQUIRES(mu_);
  static bool ParseSnapName(const std::string& name, int64_t* id,
                            std::string* base);
  // Copy-on-publish: called by Update under the exclusive lock BEFORE
  // overwriting — if any snapshot pins this var at its current
  // version and no kept copy exists yet, materialize one.
  void MaybeKeepLocked(const std::string& name, const VarInfo& v)
      DDS_REQUIRES(mu_);
  // Drop every kept version of `name` (FreeVar's snapshot half).
  void FreeKeepsLocked(const std::string& name) DDS_REQUIRES(mu_);

  // Atomic quota check-and-reserve / release (leaf lock — never nested
  // under mu_: AddInternal reserves BEFORE registration and rolls back
  // on failure).
  int TenantReserve(const std::string& tenant, int64_t bytes);
  void TenantRelease(const std::string& tenant, int64_t bytes);
  void AccountTenantRead(const std::string& name, int64_t nbytes,
                         const std::string& as_tenant = std::string());
  // Per-tenant admission bound at the given width; no shares
  // configured = the full width (pre-tenancy behavior).
  int TenantLimitLocked(const std::string& tenant, int width) const
      DDS_REQUIRES(async_mu_);

  int replication_ = 1;    // env, clamped to [1, world] at construction
  FailoverStats failover_;

  // Per-tenant ledger + quotas. Leaf mutex by design (see
  // TenantReserve); the hot-path guard is the first-byte check in
  // TenantOfVarName callers, so the default tree takes no lock here.
  struct TenantState {
    int64_t quota_bytes = -1;  // < 0 = unlimited
    int64_t quota_vars = -1;
    int64_t bytes = 0;         // registered primary shard bytes
    int64_t vars = 0;
    int64_t quota_rejections = 0;
    int64_t read_bytes = 0;    // client-side delivered
    int64_t reads = 0;
    int64_t served_bytes = 0;  // server-side (wire) traffic
    int64_t served_reads = 0;
  };
  mutable std::mutex tenants_mu_ DDS_NO_BLOCKING;
  std::map<std::string, TenantState> tenants_ DDS_GUARDED_BY(tenants_mu_);
  // True once the DEFAULT tenant "" was explicitly configured — only
  // then is unscoped traffic accounted (zero-overhead default path).
  std::atomic<bool> track_default_tenant_{false};

  // Snapshot-epoch state, guarded by the registry lock (pin/unpin and
  // kept-version lifecycle are registry mutations).
  struct SnapPin {
    std::string tenant;                   // acquiring handle's label
    std::map<std::string, int64_t> pins;  // var -> pinned update_seq
    uint64_t created_ns = 0;              // stale-pin TTL reap basis
  };
  std::map<int64_t, SnapPin> snap_pins_ DDS_GUARDED_BY(mu_);
  int64_t snap_counter_ DDS_GUARDED_BY(mu_) = 0;
  int64_t kept_versions_ DDS_GUARDED_BY(mu_) = 0;
  int64_t kept_bytes_ DDS_GUARDED_BY(mu_) = 0;
  // Pins released by the stale-pin reaper (SnapshotCounters[3]).
  std::atomic<int64_t> snap_reclaimed_{0};

  // Readers (gets, serving threads) take shared; add/init/update/free take
  // exclusive, so shard memory can't be freed or overwritten mid-read.
  // Acquired before the CMA registry's mutex (Add/Update/Rebind/Free
  // publish shard mappings while holding the exclusive lock), before
  // the integrity table mutex (Update/Rebind refresh sums under the
  // exclusive lock), before the cold-map mutex (kept-copy/mirror
  // allocations run under the exclusive lock) and before the hot-row
  // cache's mutex (Update/Rebind/FreeVar drop stale cache entries
  // inside their exclusive sections so a post-write read can never be
  // served pre-write bytes).
  mutable std::shared_mutex mu_
      DDS_ACQUIRED_BEFORE(CmaRegistry::mu_, sums_mu_, cold_mu_,
                          HotRowCache::mu_);
  std::map<std::string, VarInfo> vars_ DDS_GUARDED_BY(mu_);
  // ddmetrics histogram registry (metrics_hist.h): per-store by design
  // — a ThreadGroup's in-process ranks must not merge their latency
  // surfaces the way the process-global trace rings do. Declared
  // BEFORE transport_ like vars_/mu_ for the same reason: the TCP
  // transport's serving threads read it (the kOpMetrics serve), so it
  // must be destroyed AFTER ~Transport joins them (reverse member
  // order) — an ASan-caught teardown race otherwise.
  metrics::Registry metrics_;
  // Serving gateway (sessions + admission). Declared BEFORE transport_
  // like metrics_: the TCP transport's serving threads call
  // GatewayAttach/Renew/Detach (the kOpAttach/kOpDetach/kOpLease
  // serves), so it must outlive ~Transport's thread join.
  gw::Gateway gateway_;
  std::atomic<int> gw_admit_margin_pct_{80};
  std::atomic<int> gw_lane_share_{0};
  std::atomic<long> snap_pin_ttl_ms_{0};
  // Shed-storm flight trigger: rejects since the last flight dump.
  std::atomic<int64_t> gw_sheds_since_flight_{0};
  std::unique_ptr<Transport> transport_;
  bool fence_active_ DDS_GUARDED_BY(mu_) = false;
  bool epoch_collective_ = true;
  int64_t epoch_tag_ DDS_GUARDED_BY(mu_) = 0;

  // Scatter-read planner statistics (GetBatch runs concurrently; a plain
  // mutex is fine — one lock per batch, not per row).
  mutable std::mutex stats_mu_ DDS_NO_BLOCKING;
  PlanStats stats_ DDS_GUARDED_BY(stats_mu_);

  // Store-level transient-retry accounting (see RetryTransient).
  RetryStats retry_;
  // Deadline override consulted by RetryTransient (nanos; 0 = none —
  // int64 atomic: atomic<double> is not universally lock-free).
  std::atomic<int64_t> retry_deadline_ns_{0};

  // Async batched-read engine. The completion state is shared_ptr'd so a
  // worker finishing after Release (or ~Store's drain) never touches a
  // freed entry.
  struct AsyncState {
    std::mutex mu;
    std::condition_variable cv;
    bool done DDS_GUARDED_BY(AsyncState::mu) = false;
    int rc DDS_GUARDED_BY(AsyncState::mu) = kOk;
    // CLOCK_MONOTONIC completion time
    double done_mono_s DDS_GUARDED_BY(AsyncState::mu) = 0.0;
  };
  void DrainAsync();  // ~Store: finish every in-flight read, drop the pool
  // Synchronous body of ReadRunsAsync, run on the async pool.
  int ReadRuns(const std::string& name, char* dst,
               const std::vector<int64_t>& targets,
               const std::vector<int64_t>& src_off,
               const std::vector<int64_t>& dst_off,
               const std::vector<int64_t>& nbytes,
               const std::string& as_tenant = std::string());
  // Shared issue half of GetBatchAsync/ReadRunsAsync (and the cache
  // fills). `tenant` rides the admission gate (QoS shares) and the
  // per-tenant ledger. `detached` tickets erase THEMSELVES from the
  // ticket map at completion (no caller will ever wait/release them
  // — the cache fill's contract: a failed fill leaves
  // AsyncPending() == 0 without anyone reaping).
  int64_t SubmitAsync(const std::string& tenant, std::function<int()> fn,
                      bool detached = false);
  // Admit the next deferred async reads while running < width. Caller
  // holds async_mu_.
  void PumpAsyncLocked() DDS_REQUIRES(async_mu_);
  // Async issue/completion hot path: no getenv or other blocking call
  // may run under it (AsyncWidth() reads pre-resolved atomics only).
  // Acquired before the async pool's queue mutex (Submit runs under it).
  mutable std::mutex async_mu_ DDS_NO_BLOCKING
      DDS_ACQUIRED_BEFORE(WorkerPool::mu_);
  int64_t next_ticket_ DDS_GUARDED_BY(async_mu_) = 1;
  std::map<int64_t, std::shared_ptr<AsyncState>> async_
      DDS_GUARDED_BY(async_mu_);
  std::unique_ptr<WorkerPool> async_pool_
      DDS_GUARDED_BY(async_mu_);  // lazily created, at a fixed
  // generous thread cap; the ADMISSION width (how many reads run at
  // once) is enforced here via async_running_/async_deferred_ so the
  // scheduler can change it at runtime (SetAsyncWidth). Default width:
  // DDSTORE_ASYNC_THREADS, else the 4/2/1 core ladder.
  std::atomic<int> async_width_override_{0};  // 0 = env/ladder default
  int async_default_ = 2;  // env/ladder default, resolved at construction
  // reads admitted to the pool
  int async_running_ DDS_GUARDED_BY(async_mu_) = 0;
  // awaiting a slot (tenant-tagged: the pump admits the first entry
  // whose tenant is under ITS share bound, so a backlogged tenant
  // cannot head-of-line-block the others)
  struct DeferredRead {
    std::string tenant;
    std::function<void()> task;
  };
  std::deque<DeferredRead> async_deferred_ DDS_GUARDED_BY(async_mu_);
  // Per-tenant admission state (QoS shares). Empty share map = no
  // per-tenant gate — the exact pre-tenancy admission.
  std::map<std::string, int> async_shares_ DDS_GUARDED_BY(async_mu_);
  int64_t async_share_total_ DDS_GUARDED_BY(async_mu_) = 0;
  std::map<std::string, int> async_tenant_running_
      DDS_GUARDED_BY(async_mu_);
  std::map<std::string, int64_t> async_tenant_admitted_
      DDS_GUARDED_BY(async_mu_);
  std::map<std::string, int64_t> async_tenant_deferred_
      DDS_GUARDED_BY(async_mu_);

  // -- tiered-storage state ------------------------------------------------
  // Hot-row cache (off unless DDSTORE_TIER_CACHE_BYTES > 0; one
  // relaxed load guards every hook). Entries are filled through the
  // async pool, so DrainAsync (which runs first in ~Store) finishes
  // every fill before the cache member is destroyed.
  tier::HotRowCache tier_cache_;
  // Cold placement: directory for file-backed mirror/kept allocations
  // (DDSTORE_TIER_COLD_DIR, resolved at construction) and the
  // per-tenant policy map (DDSTORE_TIER_PLACEMENT / runtime setter).
  // cold_maps_ records every live cold mapping's length so
  // FreeOwnedShard can route frees (munmap vs transport FreeShard);
  // the mmap/ftruncate syscalls run OUTSIDE cold_mu_ — only the map
  // bookkeeping holds it.
  std::string cold_dir_;
  mutable std::mutex cold_mu_ DDS_NO_BLOCKING;
  std::map<void*, int64_t> cold_maps_ DDS_GUARDED_BY(cold_mu_);
  std::map<std::string, int> tier_placement_ DDS_GUARDED_BY(cold_mu_);
  std::atomic<int64_t> cold_placed_bytes_{0};
  // O_DIRECT cold-tier reader (lazily created by the first successful
  // SetVarFile; null until then). ColdDirectReader serializes itself
  // (its own data mutex), so ReadLocal/ReadLocalV call it through the
  // const unique_ptr while holding only the shared vars_ lock.
  // cold_direct_on_ is the one-relaxed-load guard on the hot read path
  // — the tree stays byte-identical to the mmap path until a var is
  // actually registered.
  std::unique_ptr<ColdDirectReader> cold_direct_;
  std::atomic<bool> cold_direct_on_{false};

  // -- SLO monitor state ---------------------------------------------------
  // Per-tenant latency objectives evaluated over per-window histogram
  // deltas. Leaf control-plane mutex — breaches are collected under it
  // and trace events/flight dumps emitted AFTER it drops (the ddtrace
  // no-emit-under-NO_BLOCKING discipline).
  struct SloRule {
    std::string tenant;
    int tenant_id = 0;  // interned in metrics_ at configure time
    int pct = 99;       // evaluated percentile (p50/p90/p99/...)
    uint64_t threshold_ns = 0;
    // Cumulative-aggregate baseline at the last evaluation: the
    // per-window histogram is current - base (valid because cell
    // counters and claims are monotone).
    uint64_t base_hist[metrics::kBuckets] = {};
    uint64_t base_count = 0;
  };
  mutable std::mutex slo_mu_ DDS_NO_BLOCKING;
  std::vector<SloRule> slo_rules_ DDS_GUARDED_BY(slo_mu_);
  int64_t slo_evals_ DDS_GUARDED_BY(slo_mu_) = 0;
  int64_t slo_breaches_ DDS_GUARDED_BY(slo_mu_) = 0;
  int slo_last_breach_tenant_ DDS_GUARDED_BY(slo_mu_) = -1;
  uint64_t slo_last_eval_ns_ DDS_GUARDED_BY(slo_mu_) = 0;
  long slo_window_ms_ = 0;  // DDSTORE_SLO_WINDOW_MS, ctor-resolved

  // -- integrity state -----------------------------------------------------
  // Reader-side verification on (DDSTORE_VERIFY=1 / ConfigureIntegrity).
  std::atomic<bool> verify_{false};
  // Sum computation/serving on (verify, scrub, or runtime enable). One
  // relaxed load guards every hot-path hook — the off state computes
  // nothing, fetches nothing, draws nothing.
  std::atomic<bool> integrity_on_{false};
  uint64_t sum_seed_ = 0;  // DDSTORE_VERIFY_SEED, resolved at construction
  // Leaf mutex for the sum tables: control-plane fetches and shard
  // hashing run OUTSIDE it; only table/cache publication holds it.
  // Nested under mu_ (Update/Rebind refresh under the exclusive lock)
  // — never the other way around.
  mutable std::mutex sums_mu_ DDS_NO_BLOCKING;
  // Own shards' tables (served over kOpRowSums), keyed by registry name.
  std::map<std::string, integrity::SumTable> sum_tables_
      DDS_GUARDED_BY(sums_mu_);
  // Reader-side cache of peers' tables, keyed (owner, name). shared_ptr
  // so verification walks a stable snapshot without copying the table.
  std::map<std::pair<int, std::string>,
           std::shared_ptr<const integrity::SumTable>>
      sum_cache_ DDS_GUARDED_BY(sums_mu_);
  mutable integrity::Counters icnt_;

  // Background scrubber: one resident mirror checked against its
  // owner's published sums per DDSTORE_SCRUB_MS tick (bounded rate by
  // construction), divergent mirrors re-pulled with the row-aligned
  // FillMirror chunking. Stopped (joined) in ~Store BEFORE the health
  // thread and transport teardown. scrub_cfg_mu_ serializes whole
  // stop/start transitions (held across the join); scrub_mu_ guards
  // the thread handle and cursor and is never held while blocking.
  std::mutex scrub_cfg_mu_ DDS_ACQUIRED_BEFORE(scrub_mu_);
  std::mutex scrub_mu_;
  std::atomic<bool> scrub_stop_{false};
  std::atomic<long> scrub_interval_ms_{0};
  std::string scrub_cursor_ DDS_GUARDED_BY(scrub_mu_);

  // Gateway lease/pin reaper: scrub-pattern lifecycle (gw_cfg_mu_
  // serializes whole stop/start transitions and is held across the
  // join; gw_mu_ guards only the thread handle and is never held
  // while blocking). Runs when the gateway is enabled OR a pin TTL is
  // configured (satellite: stranded-pin reclaim works gateway-off).
  std::mutex gw_cfg_mu_ DDS_ACQUIRED_BEFORE(gw_mu_);
  std::mutex gw_mu_;
  std::atomic<bool> gw_stop_{false};
  std::atomic<long> gw_reap_ms_{0};

  // Heartbeat failure detector + suspect registry. Declared LAST (with
  // the scrub thread) so it is destroyed FIRST (reverse member order):
  // the ping thread must be joined before the transport it pings goes
  // away.
  HealthMonitor health_ DDS_DESTROYED_BEFORE(transport_);
  std::thread scrub_thread_ DDS_GUARDED_BY(scrub_mu_)
      DDS_DESTROYED_BEFORE(transport_);
  std::thread gw_thread_ DDS_GUARDED_BY(gw_mu_)
      DDS_DESTROYED_BEFORE(transport_);
};

}  // namespace dds

#endif  // DDSTORE_TPU_STORE_H_
