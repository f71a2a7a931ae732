// Cross-memory-attach (CMA) fast path: same-host one-sided reads via
// shared-memory mapping (preferred) or process_vm_readv (fallback).
//
// TPU-VM hosts often run several store processes (one per chip/worker).
// Reads between them do not need sockets at all: Linux lets a same-uid
// process read another's address space directly with process_vm_readv —
// a TRUE one-sided read (single kernel copy, no serving thread, no wire).
// This is the closest TPU-host analogue of the reference's libfabric
// FI_MR_BASIC design, which likewise exchanges raw base virtual addresses
// and reads `remote_address[src] + offset`
// (reference src/common.cxx:299-306,340) — except the reference
// needs RDMA hardware for it, and this needs only the kernel.
//
// process_vm_readv's cost is per SEGMENT, and on sandboxed kernels
// (gVisor emulates the syscall in the sentry) that cost is brutal for the
// training hot path's scatter shape — hundreds of small rows per peer
// (measured on a gVisor box: 8.9 GB/s for one 32 MiB segment vs 2.3 GB/s
// for the same bytes as 1024 x 512 B segments; plain memcpy of the same
// scatter from a shared mapping runs >20 GB/s). So owned shards are
// allocated in per-variable /dev/shm files (Transport::AllocShard →
// CmaRegistry::AllocData) and the slot advertises the file id instead of
// a raw address: a reader mmaps the peer's data file ONCE and then
// gathers with plain memcpy under the same seqlock — zero per-segment
// kernel cost, which is what closes the bulk-vs-scatter bandwidth gap.
// Borrowed shards (registered with copy=False, or rebound to an mmap
// after a disk spill) cannot move into shm, so they keep the
// process_vm_readv path: the slot carries either {shm_id} or {base}.
//
// Safety: the owner publishes {base, len} per variable in a small shared-
// memory control segment guarded by a per-slot SEQLOCK. Rebind (RAM->mmap
// spill), Update, and FreeVar bump the generation around the mutation, so
// a concurrent CMA reader either sees a stable generation (data valid) or
// retries/falls back to TCP, where the store's shared_mutex serializes it
// against the mutation. A reader can never return bytes from a freed or
// half-updated backing with an even, unchanged generation.
//
// Discovery is authoritative-by-probe: peers exchange
// {pid, boot_id + pid-namespace token, segment name} over the TCP control
// channel; a token match merely permits an attempt — the first
// process_vm_readv failing with EPERM/ESRCH/EFAULT demotes the peer to
// TCP permanently. DDSTORE_CMA=0 disables the whole path.

#ifndef DDSTORE_TPU_CMA_H_
#define DDSTORE_TPU_CMA_H_

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <string>

#include "store.h"
#include "thread_annotations.h"

namespace dds {

// Bumped (0003 -> 0004) when the slot layout grew `shm_id`: a stale
// segment from an older build must be rejected by magic, not misread.
constexpr uint64_t kCmaMagic = 0xDD5C3A10C0DE0004ull;
constexpr int kCmaSlots = 256;
// Unpublish leaves a tombstone, not an empty: readers must probe PAST a
// freed slot or a hash-colliding variable behind it silently loses its
// fast path forever.
constexpr uint64_t kCmaTombstone = ~0ull;

struct CmaSlot {
  // Seqlock: even = stable, odd = mutation in progress. hash==0 = empty.
  std::atomic<uint64_t> gen;
  std::atomic<uint64_t> hash;
  // shm_id != 0: the shard lives in the owner's data file
  // "<segment-name>.d<shm_id>" and `base` is the byte offset within it
  // (currently always 0). shm_id == 0: `base` is a raw address in the
  // owner's address space, readable only via process_vm_readv.
  std::atomic<uint64_t> shm_id;
  std::atomic<uint64_t> base;
  std::atomic<uint64_t> len;
};

struct CmaSegment {
  uint64_t magic;
  int64_t pid;
  // Creator's /proc/<pid>/stat starttime (clock ticks since boot). pid
  // alone is recyclable: a crashed peer's segment can outlive it in
  // /dev/shm, and the OS may hand the pid to an unrelated same-uid
  // process whose address space process_vm_readv would then happily (and
  // wrongly) read. pid + starttime is unique for the boot.
  uint64_t start_time;
  // CmaHash of CmaHostToken() (boot-id + pid-namespace): the stale-file
  // sweeper may only judge a creator pid dead via /proc when the
  // segment was made in ITS pid namespace — containers can share a
  // /dev/shm mount without sharing a pid namespace, and an other-ns
  // owner's pid is invisible to our /proc, not dead.
  uint64_t ns_hash;
  CmaSlot slots[kCmaSlots];
};

// FNV-1a; 0 is reserved for "empty slot".
uint64_t CmaHash(const std::string& name);

// Host identity token: boot_id + pid-namespace inode. Equal tokens mean a
// CMA attempt is worth making (different pid namespaces on one host share
// a boot_id but cannot process_vm_readv each other — the probe settles it).
std::string CmaHostToken();

// starttime (field 22 of /proc/<pid>/stat) for `pid`; 0 if unreadable.
// Parsing skips past the last ')' — comm may contain spaces and parens.
uint64_t ProcStartTime(int64_t pid);

// Publisher side: owns a /dev/shm segment advertising this process's
// variable mappings.
class CmaRegistry {
 public:
  CmaRegistry();   // creates the segment; ok() false on failure
  ~CmaRegistry();  // unlinks it

  bool ok() const { return seg_ != nullptr; }
  const std::string& shm_name() const { return shm_name_; }

  // Relax Yama ptrace protection so same-uid peers can process_vm_readv
  // this process. Deferred until a peer actually asks for our CMA info
  // (the kOpCmaInfo handler) instead of done unconditionally at startup:
  // a store whose peers are all cross-host never needs the relaxation.
  void EnableReads();

  // Seqlock-publish `name`'s mapping (new slot or in-place rebind). If
  // `base` was handed out by AllocData the slot advertises the data-file
  // id (peers mmap + memcpy); otherwise the raw address (process_vm_readv).
  void Publish(const std::string& name, const void* base, int64_t len);
  // Seqlock-clear the slot; concurrent readers bounce to TCP.
  void Unpublish(const std::string& name);

  // Shard backing in shareable memory: creates "<shm_name>.d<id>" in
  // /dev/shm sized `nbytes`, maps it RW, and returns the mapping (nullptr
  // on any failure — the caller falls back to malloc and the pvm path).
  // FreeData unmaps + unlinks a mapping AllocData returned; false if the
  // pointer is not one of ours (caller should ::free it instead).
  void* AllocData(int64_t nbytes, uint64_t* id);
  bool FreeData(void* base);

 private:
  CmaSlot* FindSlot(uint64_t h, bool take_empty) DDS_REQUIRES(mu_);

  struct DataFile {
    uint64_t id;
    int64_t len;
  };

  // One writer process, many writer threads. Registration/teardown
  // path: shm file creation under it is accepted (not a hot-path
  // mutex). Ordered after the store's registry lock (PublishVar runs
  // under Store::mu_).
  std::mutex mu_;
  CmaSegment* seg_ = nullptr;
  std::string shm_name_;
  int fd_ = -1;
  std::once_flag reads_enabled_;
  // AllocData'd shard backings
  std::map<void*, DataFile> data_ DDS_GUARDED_BY(mu_);
  uint64_t next_data_id_ DDS_GUARDED_BY(mu_) = 0;
};

// Reader side: a peer's mapped segment + pid.
class CmaPeer {
 public:
  ~CmaPeer();

  // Maps `shm_name` and validates magic, pid AND the creator's starttime
  // against both the segment header and the live /proc entry, so a
  // recycled pid (crashed peer, stale segment) is rejected instead of
  // read. nullptr on any failure.
  static CmaPeer* Open(const std::string& shm_name, int64_t pid,
                       uint64_t start_time);

  // Try to serve `ops` one-sidedly: plain memcpy from the peer's mapped
  // /dev/shm data file when the slot advertises one (the scatter-read
  // fast path — zero per-segment kernel cost), process_vm_readv on the
  // raw address otherwise. Returns:
  //   kOk          — all bytes read under a stable generation
  //   kCmaFallback — mapping absent/changing/denied; caller uses TCP
  // Never returns partial data as success.
  static constexpr int kCmaFallback = 1;
  int TryReadV(const std::string& name, const ReadOp* ops, int64_t n);

  // After EPERM/ESRCH the kernel will never allow this pair; the caller
  // should drop the peer to TCP permanently.
  bool denied() const { return denied_.load(std::memory_order_relaxed); }

 private:
  CmaPeer(CmaSegment* seg, size_t map_len, int64_t pid, uint64_t start,
          std::string shm_name)
      : seg_(seg), map_len_(map_len), pid_(pid), start_time_(start),
        shm_name_(std::move(shm_name)) {}

  // Re-check that pid_ still belongs to the process that created the
  // segment (periodically and on any read failure): if the peer died and
  // the pid was recycled mid-session, reads must demote to TCP, not
  // return another process's memory.
  bool PeerStillAlive();

  // Time-throttled PeerStillAlive (at most one /proc read per ~200 ms).
  // The shm gather path needs an explicit gate: our mmap pins the data
  // file's pages, so reads from a DEAD peer would keep succeeding
  // silently forever — but the store's failure-detection contract says
  // dead peers surface as DDStoreError within bounded time. The pvm
  // path gets the same gate for free (ESRCH from the kernel).
  bool LiveRecently();

  // The peer's data file "<shm_name_>.d<id>", mapped read-only on first
  // use and cached. A cached MAP_SHARED mapping pins the file's tmpfs
  // pages (host RAM) even after the owner unlinks it (spill, FreeVar,
  // republish), so mappings are refcounted: Ensure pins, Release unpins,
  // and Ensure opportunistically munmaps unpinned mappings whose backing
  // file is gone — ids are never reused, so a deleted file can have no
  // future reader, and a gather mid-memcpy holds a pin. nullptr =
  // unmappable (negative result cached for deterministic failures only).
  struct DataMap {
    char* base;
    int64_t len;
    int pins;
  };
  const DataMap* EnsureDataMap(uint64_t id);
  void ReleaseDataMap(uint64_t id);

  CmaSegment* seg_;
  size_t map_len_;
  int64_t pid_;
  uint64_t start_time_;
  const std::string shm_name_;
  std::mutex maps_mu_;
  std::map<uint64_t, DataMap> maps_ DDS_GUARDED_BY(maps_mu_);
  std::atomic<int64_t> reads_since_check_{0};
  std::atomic<int64_t> last_live_ns_{0};
  std::atomic<bool> denied_{false};
};

}  // namespace dds

#endif  // DDSTORE_TPU_CMA_H_
