#include "trace.h"

#include <time.h>

#include <algorithm>
#include <array>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <vector>

#include "store.h"
#include "thread_annotations.h"

namespace dds {
namespace trace {

std::atomic<uint32_t> g_enabled{0};

namespace {

// One ring slot: the 48-byte Event as 6 relaxed-atomic words. The
// owner thread stores them lock-free; concurrent dump/flight readers
// load them word-wise (defined behavior — a real seqlock, not a racy
// memcpy) and the head re-read in CopyRing discards any slot the
// writer may have been mid-overwrite on.
constexpr size_t kEventWords = sizeof(Event) / sizeof(uint64_t);
using Slot = std::array<std::atomic<uint64_t>, kEventWords>;

// Per-thread ring. SINGLE-WRITER: only the owner thread writes slots/
// head. A dying thread RELEASES its ring to a free list (TlsGuard
// below) and the next new thread adopts it — rings are bounded by the
// PEAK concurrent thread count, not the cumulative one (a per-
// connection serving thread per redial must not leak a ring per chaos
// cycle) — while a released ring keeps its last events for the flight
// recorder until someone reuses it. `trim` is a reset watermark
// written only by Reset() (control plane) and read by dump — never
// touched by the writer, so the ring itself stays lock-free.
struct Ring {
  explicit Ring(uint32_t capacity, uint16_t id)
      : buf(capacity), cap(capacity), tid(id) {}
  std::vector<Slot> buf;
  std::atomic<uint64_t> head{0};  // events ever written into this ring
  std::atomic<uint64_t> trim{0};  // dump ignores indices below this
  uint32_t cap;
  uint16_t tid;
};

// Global registry of every ring plus the flight buffer.
struct Registry {
  // Control-plane mutex (registration, dump, flight, reset). Never on
  // the event hot path: Emit touches it only on a thread's FIRST
  // event. No blocking call runs under it (memcpy/alloc only).
  std::mutex mu DDS_NO_BLOCKING;
  std::vector<std::unique_ptr<Ring>> rings DDS_GUARDED_BY(mu);
  std::deque<Ring*> free_rings DDS_GUARDED_BY(mu);  // released by
  //                                                   dead threads
  std::vector<Event> flight DDS_GUARDED_BY(mu);
  int64_t flight_dumps DDS_GUARDED_BY(mu) = 0;
  // Captured/dropped totals of rings that were RESIZED on reuse (their
  // head restarts at 0): folded into Stats so the monotone totals
  // survive reuse.
  int64_t retired_captured DDS_GUARDED_BY(mu) = 0;
  int64_t retired_dropped DDS_GUARDED_BY(mu) = 0;
  std::atomic<int64_t> flight_events{0};  // gauge, read by Stats
};

Registry& Reg() {
  static Registry* r = new Registry();
  return *r;
}

std::atomic<uint64_t> g_span_counter{0};
std::atomic<long> g_ring_events{4096};
std::atomic<long> g_flight_cap{16384};

thread_local Ring* tls_ring = nullptr;
thread_local uint64_t tls_span = 0;

// Returns the thread's ring to the free list at thread exit so the
// next registering thread reuses it (see Ring above).
struct TlsGuard {
  Ring* ring = nullptr;
  ~TlsGuard() {
    if (!ring) return;
    Registry& reg = Reg();
    std::lock_guard<std::mutex> lock(reg.mu);
    reg.free_rings.push_back(ring);
  }
};
thread_local TlsGuard tls_guard;

uint64_t NowNs() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

Ring* RegisterThread() {
  Registry& reg = Reg();
  std::lock_guard<std::mutex> lock(reg.mu);
  long cap = g_ring_events.load(std::memory_order_relaxed);
  if (cap < 16) cap = 16;
  if (cap > (1 << 20)) cap = 1 << 20;
  Ring* r;
  if (!reg.free_rings.empty()) {
    // Adopt a dead thread's ring (its events stay until overwritten;
    // this thread is now the sole writer). A ring whose capacity no
    // longer matches the configured size is reallocated — safe, it is
    // writer-less while parked — with its counters folded into the
    // retired totals so captured/dropped stay monotone.
    r = reg.free_rings.front();
    reg.free_rings.pop_front();
    if (static_cast<long>(r->cap) != cap) {
      const uint64_t h = r->head.load(std::memory_order_relaxed);
      reg.retired_captured += static_cast<int64_t>(h);
      reg.retired_dropped +=
          static_cast<int64_t>(h > r->cap ? h - r->cap : 0);
      r->buf = std::vector<Slot>(static_cast<size_t>(cap));
      r->cap = static_cast<uint32_t>(cap);
      r->head.store(0, std::memory_order_relaxed);
      r->trim.store(0, std::memory_order_relaxed);
    }
  } else {
    reg.rings.push_back(std::make_unique<Ring>(
        static_cast<uint32_t>(cap),
        static_cast<uint16_t>(reg.rings.size())));
    r = reg.rings.back().get();
  }
  tls_ring = r;
  tls_guard.ring = r;
  return r;
}

void LoadSlot(const Slot& s, Event* out) {
  uint64_t words[kEventWords];
  for (size_t w = 0; w < kEventWords; ++w)
    words[w] = s[w].load(std::memory_order_relaxed);
  std::memcpy(out, words, sizeof(Event));
}

// Copy the newest `limit` valid events of `r` (at most its capacity)
// into `out`. Seqlock discipline: re-read head after the copy and drop
// indices the writer may have overwritten mid-copy. Caller holds the
// registry mutex (which only excludes OTHER readers and registration —
// the writer thread never takes it).
void CopyRing(const Ring& r, uint64_t limit, std::vector<Event>* out) {
  const uint64_t h1 = r.head.load(std::memory_order_acquire);
  const uint64_t trim = r.trim.load(std::memory_order_relaxed);
  uint64_t lo = h1 > r.cap ? h1 - r.cap : 0;
  if (trim > lo) lo = trim;
  if (limit && h1 - lo > limit) lo = h1 - limit;
  if (h1 == lo) return;
  std::vector<Event> tmp;
  tmp.resize(static_cast<size_t>(h1 - lo));
  for (uint64_t i = lo; i < h1; ++i)
    LoadSlot(r.buf[static_cast<size_t>(i % r.cap)],
             &tmp[static_cast<size_t>(i - lo)]);
  const uint64_t h2 = r.head.load(std::memory_order_acquire);
  // Events the writer may have been overwriting while we copied are
  // torn: everything below h2 - cap was overwritten, AND the slot of
  // event #h2 itself (the writer fills it BEFORE advancing head), so
  // the first trustworthy index is h2 + 1 - cap.
  const uint64_t lo2 = h2 + 1 > r.cap ? h2 + 1 - r.cap : 0;
  const uint64_t skip = lo2 > lo ? lo2 - lo : 0;
  for (uint64_t i = skip; i < h1 - lo; ++i)
    out->push_back(tmp[static_cast<size_t>(i)]);
}

// Load-time env configuration (DDSTORE_TRACE / DDSTORE_TRACE_RING /
// DDSTORE_TRACE_FLIGHT). Plain atomics only — safe at static-init.
struct EnvInit {
  EnvInit() {
    if (const char* e = std::getenv("DDSTORE_TRACE")) {
      if (std::strtol(e, nullptr, 10) != 0)
        g_enabled.store(1, std::memory_order_relaxed);
    }
    if (const char* e = std::getenv("DDSTORE_TRACE_RING")) {
      long v = std::strtol(e, nullptr, 10);
      if (v > 0) g_ring_events.store(v, std::memory_order_relaxed);
    }
    if (const char* e = std::getenv("DDSTORE_TRACE_FLIGHT")) {
      long v = std::strtol(e, nullptr, 10);
      if (v > 0) g_flight_cap.store(v, std::memory_order_relaxed);
    }
  }
};
EnvInit g_env_init;

}  // namespace

int Configure(int enabled, long ring_events) {
  if (ring_events >= 1)
    g_ring_events.store(ring_events, std::memory_order_relaxed);
  if (enabled >= 0)
    g_enabled.store(enabled ? 1 : 0, std::memory_order_relaxed);
  return 0;
}

void Reset() {
  Registry& reg = Reg();
  std::lock_guard<std::mutex> lock(reg.mu);
  for (auto& r : reg.rings)
    r->trim.store(r->head.load(std::memory_order_acquire),
                  std::memory_order_relaxed);
  reg.flight.clear();
  reg.flight_events.store(0, std::memory_order_relaxed);
}

uint64_t NewSpan(int rank) {
  const uint64_t n =
      g_span_counter.fetch_add(1, std::memory_order_relaxed) + 1;
  return (static_cast<uint64_t>(rank + 1) << 40) ^ n;
}

uint64_t CurrentSpan() { return tls_span; }
void SetCurrentSpan(uint64_t s) { tls_span = s; }

void Emit(uint16_t type, uint64_t span, int rank, int64_t a, int64_t b,
          int64_t c) {
  if (!Enabled()) return;
  Ring* r = tls_ring;
  if (!r) r = RegisterThread();
  const uint64_t h = r->head.load(std::memory_order_relaxed);
  Event e;
  e.t_ns = NowNs();
  e.span = span;
  e.type = type;
  e.tid = r->tid;
  e.rank = rank;
  e.a = a;
  e.b = b;
  e.c = c;
  uint64_t words[kEventWords];
  std::memcpy(words, &e, sizeof(Event));
  Slot& slot = r->buf[static_cast<size_t>(h % r->cap)];
  for (size_t w = 0; w < kEventWords; ++w)
    slot[w].store(words[w], std::memory_order_relaxed);
  r->head.store(h + 1, std::memory_order_release);
}

ScopedOp::~ScopedOp() {
  if (!active_) return;
  Emit(kOpEnd, CurrentSpan(), rank_, cls_, rc_, bytes_);
  // The moments the flight recorder exists for: a read whose whole
  // replica set is gone, or an admission refusal. (trace.h stays
  // store.h-free — the dtor is out of line exactly so THIS file can
  // name the real error codes.)
  if (rc_ == kErrPeerLost)
    Flight(kReasonPeerLost, rank_);
  else if (rc_ == kErrQuota)
    Flight(kReasonQuota, rank_);
  else if (rc_ == kErrCorrupt)
    Flight(kReasonCorrupt, rank_);
  SetCurrentSpan(prev_);
}

void Flight(int reason, int rank) {
  if (!Enabled()) return;
  Registry& reg = Reg();
  const uint64_t span = CurrentSpan();
  std::lock_guard<std::mutex> lock(reg.mu);
  reg.flight.clear();
  long cap = g_flight_cap.load(std::memory_order_relaxed);
  if (cap < 64) cap = 64;
  const size_t nrings = reg.rings.empty() ? 1 : reg.rings.size();
  uint64_t per = static_cast<uint64_t>(cap) / nrings;
  if (per < 64) per = 64;
  for (auto& r : reg.rings) CopyRing(*r, per, &reg.flight);
  Event marker;
  marker.t_ns = NowNs();
  marker.span = span;
  marker.type = kFlight;
  marker.tid = tls_ring ? tls_ring->tid : 0;
  marker.rank = rank;
  marker.a = reason;
  marker.b = 0;
  marker.c = 0;
  reg.flight.push_back(marker);
  ++reg.flight_dumps;
  reg.flight_events.store(static_cast<int64_t>(reg.flight.size()),
                          std::memory_order_relaxed);
}

int64_t DumpEvents(void* out, int64_t cap_bytes) {
  Registry& reg = Reg();
  std::lock_guard<std::mutex> lock(reg.mu);
  if (!out) {
    int64_t cap = 0;
    for (auto& r : reg.rings) cap += r->cap;
    return cap * static_cast<int64_t>(sizeof(Event));
  }
  std::vector<Event> all;
  for (auto& r : reg.rings) CopyRing(*r, 0, &all);
  const int64_t n = std::min<int64_t>(
      static_cast<int64_t>(all.size()),
      cap_bytes / static_cast<int64_t>(sizeof(Event)));
  if (n > 0)
    std::memcpy(out, all.data(),
                static_cast<size_t>(n) * sizeof(Event));
  return n * static_cast<int64_t>(sizeof(Event));
}

int64_t DumpFlight(void* out, int64_t cap_bytes) {
  Registry& reg = Reg();
  std::lock_guard<std::mutex> lock(reg.mu);
  if (!out)
    return static_cast<int64_t>(reg.flight.size() * sizeof(Event));
  const int64_t n = std::min<int64_t>(
      static_cast<int64_t>(reg.flight.size()),
      cap_bytes / static_cast<int64_t>(sizeof(Event)));
  if (n > 0)
    std::memcpy(out, reg.flight.data(),
                static_cast<size_t>(n) * sizeof(Event));
  return n * static_cast<int64_t>(sizeof(Event));
}

void Stats(int64_t out[12]) {
  for (int i = 0; i < 12; ++i) out[i] = 0;
  Registry& reg = Reg();
  std::lock_guard<std::mutex> lock(reg.mu);
  int64_t capacity = 0, live = 0, captured = 0, dropped = 0;
  for (auto& r : reg.rings) {
    const uint64_t h = r->head.load(std::memory_order_acquire);
    const uint64_t trim = r->trim.load(std::memory_order_relaxed);
    uint64_t lo = h > r->cap ? h - r->cap : 0;
    capacity += r->cap;
    captured += static_cast<int64_t>(h);
    dropped += static_cast<int64_t>(lo);
    const uint64_t floor_idx = trim > lo ? trim : lo;
    live += static_cast<int64_t>(h - floor_idx);
  }
  out[0] = Enabled() ? 1 : 0;
  out[1] = g_ring_events.load(std::memory_order_relaxed);
  out[2] = static_cast<int64_t>(reg.rings.size());
  out[3] = capacity;
  out[4] = live;
  out[5] = captured + reg.retired_captured;
  out[6] = dropped + reg.retired_dropped;
  out[7] = reg.flight_events.load(std::memory_order_relaxed);
  out[8] = reg.flight_dumps;
  out[9] = static_cast<int64_t>(
      g_span_counter.load(std::memory_order_relaxed));
}

}  // namespace trace
}  // namespace dds
