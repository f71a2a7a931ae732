#include "metrics_hist.h"

#include <time.h>

#include <cstdlib>
#include <cstring>

namespace dds {
namespace metrics {

namespace {
thread_local OpTimer* tls_op = nullptr;
}  // namespace

uint64_t OpTimer::NowNs() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

Registry::Registry() : cells_(new Cell[kMaxCells]) {
  std::memset(tenant_slots_, 0, sizeof(tenant_slots_));
  if (const char* e = std::getenv("DDSTORE_METRICS")) {
    // Only a PARSED zero disables: garbage ("on", "true") must keep
    // the always-on default, not silently kill the latency surface.
    char* end = nullptr;
    const long v = std::strtol(e, &end, 10);
    if (end != e && v == 0)
      enabled_.store(0, std::memory_order_relaxed);
  }
}

int Registry::Configure(int enabled) {
  if (enabled >= 0)
    enabled_.store(enabled ? 1 : 0, std::memory_order_relaxed);
  return 0;
}

void Registry::Reset() {
  for (int i = 0; i < kMaxCells; ++i) {
    Cell& c = cells_[i];
    if (c.key.load(std::memory_order_acquire) == 0) continue;
    c.count.store(0, std::memory_order_relaxed);
    c.lat_sum_ns.store(0, std::memory_order_relaxed);
    c.bytes_sum.store(0, std::memory_order_relaxed);
    for (auto& b : c.lat) b.store(0, std::memory_order_relaxed);
    for (auto& b : c.bytes) b.store(0, std::memory_order_relaxed);
  }
}

namespace {
// Slots store at most kTenantNameCap-1 bytes, so lookups must compare
// the TRUNCATED label — a full-string compare of a 48+-byte label
// against its truncated slot would never match and intern a duplicate
// slot per lookup until the table was exhausted.
bool SlotMatches(const char* slot, const std::string& tenant) {
  const size_t len =
      tenant.size() < kTenantNameCap - 1 ? tenant.size()
                                         : kTenantNameCap - 1;
  return std::strncmp(slot, tenant.data(), len) == 0 &&
         slot[len] == '\0';
}
}  // namespace

int Registry::TenantId(const std::string& tenant) {
  if (tenant.empty()) return 0;
  // Labels with control characters or the CSV separator cannot come
  // through any validated entry point (the Python boundary and the
  // native spec parsers all reject them) — fold anything reaching the
  // raw capi hook into slot 0 so TenantNamesCsv's format can never be
  // corrupted.
  for (const char c : tenant)
    if (static_cast<unsigned char>(c) < 0x20 || c == ',') {
      tenant_overflow_.fetch_add(1, std::memory_order_relaxed);
      return 0;
    }
  // Lock-free scan of the published prefix: slots are immutable once
  // the count's release-store made them visible.
  const int n = tenant_count_.load(std::memory_order_acquire);
  for (int i = 1; i < n; ++i)
    if (SlotMatches(tenant_slots_[i].name, tenant)) return i;
  std::lock_guard<std::mutex> lock(mu_);
  const int n2 = tenant_count_.load(std::memory_order_relaxed);
  for (int i = 1; i < n2; ++i)
    if (SlotMatches(tenant_slots_[i].name, tenant)) return i;
  if (n2 >= kMaxTenants) {
    tenant_overflow_.fetch_add(1, std::memory_order_relaxed);
    return 0;  // fold into the default slot; counted, never blocks
  }
  std::strncpy(tenant_slots_[n2].name, tenant.c_str(),
               kTenantNameCap - 1);
  tenant_slots_[n2].name[kTenantNameCap - 1] = '\0';
  tenant_count_.store(n2 + 1, std::memory_order_release);
  return n2;
}

int Registry::TenantNamesCsv(char* out, int cap) const {
  if (!out || cap <= 0) return 0;
  const int n = tenant_count_.load(std::memory_order_acquire);
  int pos = 0;
  for (int i = 0; i < n; ++i) {
    const char* name = i == 0 ? "" : tenant_slots_[i].name;
    const int len = static_cast<int>(std::strlen(name));
    if (pos + len + 2 > cap) break;
    if (i > 0) out[pos++] = ',';
    std::memcpy(out + pos, name, static_cast<size_t>(len));
    pos += len;
  }
  out[pos < cap ? pos : cap - 1] = '\0';
  return pos;
}

uint64_t Registry::PackKey(int cls, int route, int peer, int tenant_id) {
  // peer + 1 so peer -1 (multi) packs as 0; the claim bit keeps a key
  // of all-zero fields distinct from a free slot.
  return (1ull << 63) |
         (static_cast<uint64_t>(cls & 0xff) << 48) |
         (static_cast<uint64_t>(route & 0xff) << 40) |
         (static_cast<uint64_t>(tenant_id & 0xffff) << 24) |
         (static_cast<uint64_t>(peer + 1) & 0xffffff);
}

Registry::Cell* Registry::FindCell(uint64_t key) {
  // splitmix-style scramble so adjacent peers don't cluster.
  uint64_t h = key;
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  for (int probe = 0; probe < kMaxCells; ++probe) {
    Cell& c = cells_[(h + probe) % kMaxCells];
    uint64_t k = c.key.load(std::memory_order_acquire);
    if (k == key) return &c;
    if (k == 0) {
      uint64_t expected = 0;
      // Release on success: a snapshot reader that sees the key sees a
      // fully constructed (zeroed) cell.
      if (c.key.compare_exchange_strong(expected, key,
                                        std::memory_order_acq_rel))
        return &c;
      if (expected == key) return &c;  // lost the race to ourselves
    }
  }
  return nullptr;  // table full
}

void Registry::Record(int cls, int route, int peer, int tenant_id,
                      uint64_t lat_ns, uint64_t bytes) {
  Cell* c = FindCell(PackKey(cls, route, peer, tenant_id));
  if (!c) {
    dropped_.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  c->count.fetch_add(1, std::memory_order_relaxed);
  c->lat_sum_ns.fetch_add(lat_ns, std::memory_order_relaxed);
  c->lat[BucketOf(lat_ns)].fetch_add(1, std::memory_order_relaxed);
  c->bytes_sum.fetch_add(bytes, std::memory_order_relaxed);
  c->bytes[BucketOf(bytes)].fetch_add(1, std::memory_order_relaxed);
  recorded_.fetch_add(1, std::memory_order_relaxed);
}

int64_t Registry::Snapshot(void* out, int64_t cap_bytes) const {
  constexpr int64_t kRec = static_cast<int64_t>(sizeof(CellRecord));
  if (!out) return kMaxCells * kRec;
  char* p = static_cast<char*>(out);
  int64_t written = 0;
  for (int i = 0; i < kMaxCells; ++i) {
    const Cell& c = cells_[i];
    const uint64_t key = c.key.load(std::memory_order_acquire);
    if (key == 0) continue;
    const uint64_t count = c.count.load(std::memory_order_relaxed);
    if (count == 0) continue;  // claimed but not yet (or reset) counted
    if (written + kRec > cap_bytes) break;
    CellRecord r;
    std::memset(&r, 0, sizeof(r));
    r.cls = static_cast<int32_t>((key >> 48) & 0xff);
    r.route = static_cast<int32_t>((key >> 40) & 0xff);
    r.peer = static_cast<int32_t>(key & 0xffffff) - 1;
    const int tid = static_cast<int>((key >> 24) & 0xffff);
    if (tid > 0 && tid < tenant_count_.load(std::memory_order_acquire))
      std::strncpy(r.tenant, tenant_slots_[tid].name,
                   kTenantNameCap - 1);
    r.count = count;
    r.lat_sum_ns = c.lat_sum_ns.load(std::memory_order_relaxed);
    r.bytes_sum = c.bytes_sum.load(std::memory_order_relaxed);
    for (int b = 0; b < kBuckets; ++b) {
      r.lat[b] = c.lat[b].load(std::memory_order_relaxed);
      r.bytes[b] = c.bytes[b].load(std::memory_order_relaxed);
    }
    std::memcpy(p + written, &r, sizeof(r));
    written += kRec;
  }
  return written;
}

void Registry::TenantLatHist(int tenant_id, uint64_t hist[kBuckets],
                             uint64_t* count) const {
  for (int b = 0; b < kBuckets; ++b) hist[b] = 0;
  uint64_t n = 0;
  for (int i = 0; i < kMaxCells; ++i) {
    const Cell& c = cells_[i];
    const uint64_t key = c.key.load(std::memory_order_acquire);
    if (key == 0) continue;
    if (static_cast<int>((key >> 24) & 0xffff) != tenant_id) continue;
    for (int b = 0; b < kBuckets; ++b)
      hist[b] += c.lat[b].load(std::memory_order_relaxed);
    n += c.count.load(std::memory_order_relaxed);
  }
  if (count) *count = n;
}

void Registry::Stats(int64_t out[kNumStats]) const {
  for (int i = 0; i < kNumStats; ++i) out[i] = 0;
  int64_t used = 0;
  for (int i = 0; i < kMaxCells; ++i)
    if (cells_[i].key.load(std::memory_order_acquire) != 0) ++used;
  out[0] = enabled() ? 1 : 0;
  out[1] = used;
  out[2] = kMaxCells;
  out[3] = dropped_.load(std::memory_order_relaxed);
  out[4] = tenant_count_.load(std::memory_order_acquire);
  out[5] = tenant_overflow_.load(std::memory_order_relaxed);
  out[6] = recorded_.load(std::memory_order_relaxed);
}

OpTimer::OpTimer(Registry* reg, int cls, int peer, int tenant_id,
                 uint64_t bytes, uint64_t t0_ns)
    : reg_(reg && reg->enabled() ? reg : nullptr) {
  if (!reg_) return;
  if (tls_op) {
    // Nested op (the async issue->completion bracket already timing
    // this thread's inner GetBatch/ReadRuns execution leg): ONE op =
    // ONE sample — recording both would double-count the tenant's
    // traffic and dilute the SLO quantile with the faster execution
    // legs, masking a queueing-driven breach. Route marks land on the
    // enclosing (sole) active token; at most one token is ever live
    // per thread.
    reg_ = nullptr;
    return;
  }
  t0_ns_ = t0_ns ? t0_ns : NowNs();
  cls_ = cls;
  peer_ = peer;
  tenant_ = tenant_id;
  bytes_ = bytes;
  tls_op = this;
}

OpTimer::~OpTimer() {
  if (!reg_) return;
  tls_op = nullptr;
  const uint64_t now = NowNs();
  reg_->Record(cls_, route_, peer_, tenant_,
               now > t0_ns_ ? now - t0_ns_ : 0, bytes_);
}

void OpTimer::MarkRoute(int route) {
  if (tls_op && route > tls_op->route_) tls_op->route_ = route;
}

}  // namespace metrics
}  // namespace dds
