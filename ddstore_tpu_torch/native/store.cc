#include "store.h"

#include <algorithm>
#include <chrono>
#include <cstring>
#include <memory>
#include <thread>

#include "trace.h"
#include "uring_transport.h"
#include "worker_pool.h"

namespace dds {

namespace {
double MonoSeconds() {
  // steady_clock is CLOCK_MONOTONIC on Linux/glibc — the same clock
  // Python's time.monotonic() reads, so completion timestamps compare
  // directly against consumer-side timestamps.
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Thread cap of the (lazily created) async pool. The ADMISSION width —
// how many reads actually run at once — is enforced separately in
// SubmitAsync/PumpAsyncLocked, so this only needs to cover the largest
// width the scheduler may ever set (threads are created lazily; an
// unused cap costs nothing).
constexpr int kAsyncPoolCap = 16;

long AsyncThreadsFromEnv() {
  if (const char* env = std::getenv("DDSTORE_ASYNC_THREADS")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v > 0)
      return v < kAsyncPoolCap ? v : kAsyncPoolCap;
  }
  // Default from the core count — the same 4/2/1 ladder the transport
  // lane pool uses (tcp_transport.cc): admission width and lane fan-out
  // compete for the same cores, so they scale by the same rule. One
  // in-flight window is the readahead steady state; extra slots absorb
  // a co-variable (labels) and deeper rings, but only pay where there
  // are cores to run them.
  const unsigned hw = std::thread::hardware_concurrency();
  return hw >= 8 ? 4 : (hw >= 4 ? 2 : 1);
}

// In-flight accounting around one admitted read op (Drain waits on
// it; OpEnd wakes deferred waiters). Null gateway = gateway off =
// zero-cost scope.
struct GwOpScope {
  gw::Gateway* g;
  explicit GwOpScope(gw::Gateway* gg) : g(gg) {
    if (g) g->OpBegin();
  }
  ~GwOpScope() {
    if (g) g->OpEnd();
  }
};
}  // namespace

const char* ErrorString(int code) {
  switch (code) {
    case kOk: return "ok";
    case kErrInvalidArg: return "invalid argument";
    case kErrNotFound: return "variable not found";
    case kErrOutOfRange: return "row range out of bounds";
    case kErrCrossShard: return "row range spans more than one shard";
    case kErrEpochState: return "mismatched epoch_begin/epoch_end";
    case kErrTransport: return "transport error";
    case kErrExists: return "variable already exists";
    case kErrNoMem: return "out of memory";
    case kErrShapeMismatch: return "shape mismatch across ranks";
    case kErrPeerLost: return "peer unreachable (transient-retry budget "
                              "exhausted; owner presumed dead)";
    case kErrQuota: return "tenant quota exceeded (admission refused; "
                           "free variables or raise the budget)";
    case kErrCorrupt: return "data integrity failure (delivered bytes "
                             "disagree with the owner's published "
                             "checksums on every readable holder)";
    case kErrAdmission: return "gateway admission refused (over-share "
                               "tenant deferred past its window or rank "
                               "draining; back off and retry)";
    default: return "unknown error";
  }
}

// -- tenant name scoping ------------------------------------------------------

std::string TenantOfVarName(const std::string& name) {
  // See through the hidden-variable wrappers so mirror pulls and
  // snapshot reads attribute to the tenant owning the data underneath.
  size_t pos = 0;
  for (int depth = 0; depth < 4; ++depth) {  // wrappers never nest deeper
    if (pos >= name.size()) return "";
    const char c = name[pos];
    if (c == '\x01' || c == '\x03') {
      // "\x01mirror\x01<owner>\x01<rest>" / "\x03s\x03<id>\x03<rest>" /
      // "\x03k\x03<seq>\x03<rest>": skip two more delimiters.
      size_t p = name.find(c, pos + 1);
      if (p == std::string::npos) return "";
      p = name.find(c, p + 1);
      if (p == std::string::npos) return "";
      pos = p + 1;
      continue;
    }
    if (c == '\x02') {
      const size_t end = name.find('\x02', pos + 1);
      if (end == std::string::npos) return "";
      return name.substr(pos + 1, end - pos - 1);
    }
    return "";
  }
  return "";
}

namespace {
int ReplicationFromEnv(int world) {
  long r = 1;
  if (const char* env = std::getenv("DDSTORE_REPLICATION")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v >= 1) r = v;
  }
  if (r > world) r = world;  // R holders need R distinct ranks
  return static_cast<int>(r);
}
}  // namespace

namespace {
// "tenant=value[,tenant=value...]" env specs (quota values additionally
// carry an optional ":vars" suffix). Malformed entries are skipped —
// config parsing must never fail store construction.
void ParseTenantSpec(
    const char* env,
    const std::function<void(const std::string&, const std::string&)>& fn) {
  if (!env) return;
  const std::string s(env);
  size_t pos = 0;
  while (pos <= s.size()) {
    size_t next = s.find(',', pos);
    if (next == std::string::npos) next = s.size();
    const std::string entry = s.substr(pos, next - pos);
    const size_t eq = entry.find('=');
    if (eq != std::string::npos && eq > 0) {
      const std::string tenant = entry.substr(0, eq);
      // Control characters collide with the native name-scoping and
      // names-CSV wire formats — such a label is malformed, skip it.
      bool ok = true;
      for (const char c : tenant)
        ok = ok && static_cast<unsigned char>(c) >= 0x20;
      if (ok) fn(tenant, entry.substr(eq + 1));
    }
    pos = next + 1;
  }
}
}  // namespace

Store::Store(std::unique_ptr<Transport> transport)
    : transport_(std::move(transport)),
      // Resolved once per store (the pre-admission-gate code read the
      // env once at pool creation): AsyncWidth() runs on the async
      // issue/completion hot path under async_mu_ and must not
      // getenv/strtol there.
      async_default_(static_cast<int>(AsyncThreadsFromEnv())) {
  replication_ = ReplicationFromEnv(world());
  // Tenant quotas/shares from the environment (runtime setters exist
  // too). DDSTORE_TENANT_QUOTAS="t=bytes[:vars],..."
  // DDSTORE_TENANT_SHARES="t=weight,...".
  ParseTenantSpec(
      std::getenv("DDSTORE_TENANT_QUOTAS"),
      [this](const std::string& t, const std::string& v) {
        char* end = nullptr;
        const long long b = std::strtoll(v.c_str(), &end, 10);
        if (end == v.c_str()) return;  // no bytes value: skip entry
        long long nv = -1;
        if (*end == ':') {
          // Optional ":vars" suffix. A bare trailing ':' means
          // unlimited (the Python parser agrees); junk after it skips
          // the entry — it must NOT parse as quota_vars=0, which
          // would refuse every registration for the tenant.
          const char* vs = end + 1;
          if (*vs) {
            char* end2 = nullptr;
            const long long parsed = std::strtoll(vs, &end2, 10);
            if (end2 == vs || *end2) return;
            nv = parsed;
          }
        } else if (*end) {
          return;  // junk after the bytes value: skip entry
        }
        SetTenantQuota(t, b, nv);
      });
  ParseTenantSpec(
      std::getenv("DDSTORE_TENANT_SHARES"),
      [this](const std::string& t, const std::string& v) {
        char* end = nullptr;
        const long w = std::strtol(v.c_str(), &end, 10);
        // Junk after the weight (e.g. a ';' typo for ',') skips the
        // entry, matching the quotas parser and the Python mirror.
        if (end != v.c_str() && !*end && w >= 1)
          SetTenantShare(t, static_cast<int>(w));
      });
  // Integrity: sum computation engages when anything can consume the
  // sums (reader verification or the scrubber); the default tree
  // computes nothing, fetches nothing, draws nothing.
  sum_seed_ = integrity::SeedFromEnv();
  if (const char* env = std::getenv("DDSTORE_VERIFY"))
    verify_.store(std::strtol(env, nullptr, 10) != 0,
                  std::memory_order_relaxed);
  long scrub_ms = 0;
  if (const char* env = std::getenv("DDSTORE_SCRUB_MS")) {
    char* end = nullptr;
    const long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) scrub_ms = v;
  }
  integrity_on_.store(
      verify_.load(std::memory_order_relaxed) || scrub_ms > 0,
      std::memory_order_relaxed);
  // Tiered storage: hot-row cache budget, cold-file directory and the
  // per-tenant mirror/kept placement policy. All default OFF — the
  // unconfigured tree is byte-identical to the pre-tiering store.
  if (const char* env = std::getenv("DDSTORE_TIER_CACHE_BYTES")) {
    char* end = nullptr;
    const long long v = std::strtoll(env, &end, 10);
    if (end != env && v >= 0) tier_cache_.Configure(v);
  }
  if (const char* env = std::getenv("DDSTORE_TIER_COLD_DIR"))
    cold_dir_ = env;
  if (const char* env = std::getenv("DDSTORE_TIER_PLACEMENT")) {
    // "tenant=cold[,tenant=hot,...]"; a bare "cold"/"hot" entry names
    // the DEFAULT tenant (the quota-spec parser cannot express "",
    // and default-tenant mirrors are the common single-tenant case).
    const std::string s(env);
    size_t pos = 0;
    while (pos <= s.size()) {
      size_t next = s.find(',', pos);
      if (next == std::string::npos) next = s.size();
      const std::string entry = s.substr(pos, next - pos);
      const size_t eq = entry.find('=');
      const std::string tenant =
          eq == std::string::npos ? "" : entry.substr(0, eq);
      const std::string val =
          eq == std::string::npos ? entry : entry.substr(eq + 1);
      bool ok = !tenant.empty() || eq == std::string::npos ||
                entry.compare(0, 1, "=") == 0;
      for (const char c : tenant)
        ok = ok && static_cast<unsigned char>(c) >= 0x20;
      if (ok && (val == "cold" || val == "hot"))
        SetTierPlacement(tenant, val == "cold" ? 1 : 0);
      pos = next + 1;
    }
  }
  // SLO monitor: per-tenant latency objectives over the ddmetrics
  // histograms. Default OFF (no spec = inert, not a single branch past
  // the empty-rules check); DDSTORE_SLO_WINDOW_MS rate-limits how
  // often EvaluateSlos actually evaluates.
  if (const char* env = std::getenv("DDSTORE_SLO_WINDOW_MS")) {
    char* end = nullptr;
    const long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) slo_window_ms_ = v;
  }
  if (const char* env = std::getenv("DDSTORE_TENANT_SLOS"))
    SetTenantSlos(env);
  // Serving gateway (gateway.h). Default OFF: the whole feature costs
  // one relaxed load per read op and starts no thread. The reaper also
  // arms when only DDSTORE_SNAP_PIN_TTL_MS is set — stranded-pin
  // reclaim is a standalone fix that works with the gateway off.
  {
    auto env_long = [](const char* name, long dflt) {
      const char* env = std::getenv(name);
      if (!env || !*env) return dflt;
      char* end = nullptr;
      const long v = std::strtol(env, &end, 10);
      return end != env ? v : dflt;
    };
    const int gw_on = env_long("DDSTORE_GATEWAY", 0) > 0 ? 1 : 0;
    const long pin_ttl = env_long("DDSTORE_SNAP_PIN_TTL_MS", 0);
    if (gw_on || pin_ttl > 0)
      ConfigureGateway(gw_on, env_long("DDSTORE_GW_LEASE_MS", 5000),
                       env_long("DDSTORE_GW_DEFER_MS", 100),
                       static_cast<int>(env_long("DDSTORE_GW_QUEUE", 64)),
                       static_cast<int>(
                           env_long("DDSTORE_GW_ADMIT_MARGIN", 80)),
                       static_cast<int>(
                           env_long("DDSTORE_GW_LANE_SHARE", 0)),
                       pin_ttl);
  }
  health_.Init(rank(), world());
  if (scrub_ms > 0) ConfigureScrub(scrub_ms);
  if (world() > 1) {
    // Transports with an internal retry layer (TCP leaves) consult the
    // suspect view between attempts (snapshotted once per leaf; the
    // checks themselves are relaxed atomic loads). A never-marked view
    // changes nothing — R=1 counters stay identical.
    transport_->SetSuspectOracle(
        [this](int t) { return PeerSuspected(t); });
    const long interval = HeartbeatIntervalMsFromEnv(replication_);
    if (interval > 0)
      health_.Start(interval, HeartbeatSuspectNFromEnv(),
                    [this, interval](int t) {
                      return transport_->Ping(t, interval);
                    });
  }
}

Store::~Store() {
  // The scrubber reads shards and the control plane; the ping thread
  // dials through the transport: both must stop before any teardown
  // the transport participates in. The gateway reaper releases leases
  // through the same control plane, so it stops first; gw_stop_ also
  // aborts any admission defer-wait still parked in a reader thread.
  StopGwReaper();
  StopScrub();
  health_.Stop();
  // In-flight async reads hold the shared lock and use the transport;
  // both must still exist while they finish.
  DrainAsync();
  FreeAll();
}

void Store::DrainAsync() {
  std::unique_ptr<WorkerPool> pool;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    // Admission-deferred reads must still complete — a waiter in
    // AsyncRelease blocks on their AsyncState. Hand them all to the
    // pool (ignoring width AND tenant shares; this is teardown): its
    // dtor runs every queued task before joining.
    while (!async_deferred_.empty()) {
      ++async_running_;
      ++async_tenant_running_[async_deferred_.front().tenant];
      async_pool_->Submit(std::move(async_deferred_.front().task));
      async_deferred_.pop_front();
    }
    pool = std::move(async_pool_);
    async_.clear();  // workers hold their AsyncState via shared_ptr
  }
  pool.reset();  // WorkerPool dtor runs every queued task, then joins
}

int Store::rank() const { return transport_->rank(); }
int Store::world() const { return transport_->world(); }

int Store::OwnerOf(const std::vector<int64_t>& cum, int64_t row) {
  // First rank whose cumulative count exceeds `row`. cum is nondecreasing;
  // empty shards (cum[r] == cum[r-1]) are skipped naturally by upper_bound.
  auto it = std::upper_bound(cum.begin(), cum.end(), row);
  if (it == cum.end()) return -1;
  return static_cast<int>(it - cum.begin());
}

int Store::AddInternal(const std::string& name, const void* buf, int64_t nrows,
                       int64_t disp, int64_t itemsize,
                       const int64_t* all_nrows, bool copy, bool zero_fill) {
  if (name.empty() || disp <= 0 || itemsize <= 0 || nrows < 0)
    return kErrInvalidArg;
  // Tenant admission: check-and-reserve the byte/var budget atomically
  // BEFORE registration (leaf lock, never nested under mu_) and roll
  // back on any failure below. Unscoped names skip this entirely
  // unless the default tenant was explicitly configured — the default
  // tree takes no tenant lock at all. The charge is the LARGEST rank's
  // shard bytes: add() is collective and every rank sees the same
  // all_nrows, so every rank reaches the SAME verdict — an uneven
  // shard must never half-register (ERR_QUOTA on one rank, kOk and a
  // stranded registration on another).
  int64_t maxrows = 0;
  for (int r = 0; r < world(); ++r)
    if (all_nrows[r] > maxrows) maxrows = all_nrows[r];
  const int64_t tbytes = maxrows * disp * itemsize;
  std::string tenant;
  bool reserved = false;
  if (name[0] == '\x02' ||
      track_default_tenant_.load(std::memory_order_relaxed)) {
    {
      // Classify a duplicate registration BEFORE the quota gate: an
      // at-budget tenant re-adding an existing name must get
      // kErrExists (the pre-tenancy answer), not a spurious
      // kErrQuota + quota_rejections tick telling it to free/raise.
      std::shared_lock<std::shared_mutex> rl(mu_);
      if (vars_.count(name)) return kErrExists;
    }
    tenant = TenantOfVarName(name);
    int qrc = TenantReserve(tenant, tbytes);
    if (qrc != kOk) return qrc;
    reserved = true;
  }
  auto fail = [&](int rc) {
    if (reserved) TenantRelease(tenant, tbytes);
    return rc;
  };
  std::unique_lock<std::shared_mutex> lock(mu_);
  if (vars_.count(name)) return fail(kErrExists);

  VarInfo v;
  v.name = name;
  v.disp = disp;
  v.itemsize = itemsize;
  v.nrows = nrows;
  if (reserved) v.quota_reserved = tbytes;
  v.cum.resize(world());
  int64_t acc = 0;
  for (int r = 0; r < world(); ++r) {
    if (all_nrows[r] < 0) return fail(kErrInvalidArg);
    acc += all_nrows[r];
    v.cum[r] = acc;
  }
  // Sanity: our slot in the table must match what we were handed.
  if (all_nrows[rank()] != nrows) return fail(kErrShapeMismatch);

  int64_t bytes = nrows * disp * itemsize;
  if (zero_fill || copy) {
    // Owned allocations go through the transport so a same-host fast path
    // can back them with shareable memory (see Transport::AllocShard).
    v.base = static_cast<char*>(transport_->AllocShard(name, bytes));
    if (!v.base) return fail(kErrNoMem);
    v.owned = true;
    if (zero_fill) {
      std::memset(v.base, 0, bytes);
    } else {
      std::memcpy(v.base, buf, bytes);
    }
  } else {
    // Borrow the caller's buffer (zero-copy registration).
    v.base = static_cast<char*>(const_cast<void*>(buf));
    v.owned = false;
  }
  const VarInfo& placed = vars_.emplace(name, std::move(v)).first->second;
  transport_->PublishVar(name, placed.base, placed.shard_bytes());
  lock.unlock();
  // Eager sum build at registration (EnsureOwnSums takes the shared
  // lock itself): the owner's table exists before any holder can pull
  // a mirror or verify a read against it.
  if (integrity_on_.load(std::memory_order_relaxed)) EnsureOwnSums(name);
  return kOk;
}

int Store::Add(const std::string& name, const void* buf, int64_t nrows,
               int64_t disp, int64_t itemsize, const int64_t* all_nrows,
               bool copy) {
  if (!buf && nrows > 0) return kErrInvalidArg;
  return AddInternal(name, buf, nrows, disp, itemsize, all_nrows, copy,
                     /*zero_fill=*/false);
}

int Store::Init(const std::string& name, int64_t nrows, int64_t disp,
                int64_t itemsize, const int64_t* all_nrows) {
  return AddInternal(name, nullptr, nrows, disp, itemsize, all_nrows,
                     /*copy=*/false, /*zero_fill=*/true);
}

int Store::Update(const std::string& name, const void* buf, int64_t nrows,
                  int64_t row_offset) {
  if (!buf || nrows < 0 || row_offset < 0) return kErrInvalidArg;
  std::unique_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  if (it == vars_.end()) return kErrNotFound;
  VarInfo& v = it->second;
  if (row_offset + nrows > v.nrows) return kErrOutOfRange;
  // Snapshot copy-on-publish: if any snapshot pins this shard at its
  // CURRENT version and no kept copy exists yet, materialize one
  // before the overwrite — still under the exclusive lock, so a
  // concurrent snapshot read resolves to either the primary (old
  // bytes) or the kept copy (same old bytes), never a torn mix.
  MaybeKeepLocked(name, v);
  // CMA readers are not serialized by mu_; bounce them to the TCP path
  // (which is) for the duration of the overwrite.
  transport_->UnpublishVar(name);
  std::memcpy(v.base + row_offset * v.row_bytes(), buf,
              nrows * v.row_bytes());
  ++v.update_seq;  // mirror holders re-pull at their next epoch fence
  if (integrity_on_.load(std::memory_order_relaxed)) {
    // Refresh the sum table IN the exclusive section, so data at seq S
    // and sums at seq S publish atomically with respect to readers
    // (the verify ladder's seq-race retry handles cross-epoch skew;
    // a table that lagged its data by one Update inside the lock
    // would make every post-update verified read a false mismatch).
    std::lock_guard<std::mutex> sl(sums_mu_);
    auto t = sum_tables_.find(name);
    if (t != sum_tables_.end()) {
      integrity::SumTable& st = t->second;
      if (st.seq == v.update_seq - 1 &&
          static_cast<int64_t>(st.sums.size()) == v.nrows) {
        const int64_t rb = v.row_bytes();
        for (int64_t r = row_offset; r < row_offset + nrows; ++r)
          st.sums[static_cast<size_t>(r)] =
              integrity::RowSum(v.base + r * rb, rb, r, sum_seed_);
        st.seq = v.update_seq;
        icnt_.sums_computed.fetch_add(1, std::memory_order_relaxed);
        icnt_.sums_rows.fetch_add(nrows, std::memory_order_relaxed);
      } else {
        // Stale/foreign table: drop it — the next serve rebuilds lazily.
        sum_tables_.erase(t);
      }
    }
  }
  // Cache coherence: warmed copies of the pre-update bytes must never
  // serve a post-update read — dropped INSIDE the exclusive section
  // (quota charges returned after the lock; tenants_mu_ stays a leaf).
  std::vector<std::shared_ptr<tier::Entry>> dropped;
  if (tier_cache_.enabled()) tier_cache_.DropVar(name, &dropped);
  transport_->PublishVar(name, v.base, v.shard_bytes());
  lock.unlock();
  ReleaseTierQuota(dropped);
  return kOk;
}

int Store::Get(const std::string& name, void* dst, int64_t start,
               int64_t count, const std::string& as_tenant) {
  if (!dst || start < 0 || count <= 0) return kErrInvalidArg;
  // Gateway admission gate: one relaxed load when off.
  if (gateway_.enabled()) {
    const int arc = GatewayAdmit(name, as_tenant);
    if (arc != kOk) return arc;
  }
  GwOpScope gw_scope(gateway_.enabled() ? &gateway_ : nullptr);
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  if (start + count > v.total_rows()) return kErrOutOfRange;

  int target = OwnerOf(v.cum, start);
  if (target < 0) return kErrOutOfRange;
  int64_t shard_begin = target == 0 ? 0 : v.cum[target - 1];
  // Whole range must live on one shard (single-peer reads; the reference
  // enforces the same, ddstore.hpp:210-214).
  if (start + count > v.cum[target]) return kErrCrossShard;

  int64_t offset = (start - shard_begin) * v.row_bytes();
  int64_t nbytes = count * v.row_bytes();
  // Span root of this read: every transport/retry/failover event below
  // (including the serving rank's, via the frame tag) records under it.
  trace::ScopedOp top(rank(), trace::kClsGet, target, nbytes);
  // ddmetrics: one histogram sample per op at destruction (latency,
  // bytes, route upgraded by the transport). One relaxed load when off.
  metrics::OpTimer mtimer(
      &metrics_, trace::kClsGet, target,
      metrics_.enabled()
          ? metrics_.TenantId(as_tenant.empty() ? TenantOfVarName(name)
                                                : as_tenant)
          : 0,
      static_cast<uint64_t>(nbytes));
  // Hot-row cache consult (tiered storage): a warmed range is one
  // memcpy, local or remote owner alike. One relaxed load when off.
  if (tier_cache_.enabled() &&
      TierServe(name, v, target, offset, nbytes, dst)) {
    AccountTenantRead(name, nbytes, as_tenant);
    return top.ret(kOk);
  }
  // The retried primary read, shared by both replication branches and
  // (as the `reread` hook) by the verify ladder.
  auto primary_read = [&]() {
    return RetryTransient(
        [&]() {
          return transport_->Read(target, name, offset, nbytes, dst);
        },
        target);
  };
  int rc;
  if (target == rank()) {
    rc = ReadLocal(name, offset, nbytes, dst);
  } else if (replication_ <= 1) {
    rc = primary_read();
    if (rc == kOk && verify_.load(std::memory_order_relaxed)) {
      const ReadOp op{offset, nbytes, dst};
      rc = VerifyAfterRead(name, target, &op, 1, primary_read);
    }
  } else {
    // Replicated single-peer read: same failover contract as the
    // batched paths (suspect short-circuit, ladder verdict -> replica
    // chain, kErrPeerLost only when every holder is gone) but without
    // the batched plan's per-call map — the healthy-primary common
    // case is one direct retried read, exactly the R=1 fast path.
    rc = kErrPeerLost;
    bool via_replica = true;
    if (!PeerSuspected(target)) {
      rc = primary_read();
      via_replica = rc == kErrPeerLost;
      if (via_replica) MarkPeerSuspected(target);
    } else {
      failover_.suspect_skips.fetch_add(1, std::memory_order_relaxed);
    }
    if (via_replica) {
      std::vector<ReadOp> ops(1, ReadOp{offset, nbytes, dst});
      rc = ReadViaReplica(name, target, ops);
    } else if (rc == kOk && verify_.load(std::memory_order_relaxed)) {
      const ReadOp op{offset, nbytes, dst};
      rc = VerifyAfterRead(name, target, &op, 1, primary_read);
    }
  }
  if (rc == kOk) AccountTenantRead(name, nbytes, as_tenant);
  return top.ret(rc);
}

namespace {
// One planned contiguous run: `nrows` source-adjacent rows in `target`'s
// shard. `first` indexes the sorted (row, slot) table; the run covers
// sorted entries [first, first+nrows), whose slots give each row's final
// position in dst.
struct Run {
  int target;
  int64_t offset;   // byte offset in target's shard
  int64_t nrows;
  int64_t first;    // index of the run's first entry in the sorted table
  bool direct;      // output slots are contiguous too: read straight to dst
};
}  // namespace

int Store::GetBatch(const std::string& name, void* dst, const int64_t* starts,
                    int64_t n, const std::string& as_tenant) {
  // Gateway admission gate: PUBLIC entry only — internal cache fills
  // (GetBatchImpl with use_cache=false) are never gated, they run on
  // behalf of already-admitted work. One relaxed load when off.
  if (gateway_.enabled()) {
    const int arc = GatewayAdmit(name, as_tenant);
    if (arc != kOk) return arc;
  }
  GwOpScope gw_scope(gateway_.enabled() ? &gateway_ : nullptr);
  return GetBatchImpl(name, dst, starts, n, as_tenant,
                      /*use_cache=*/true);
}

int Store::GetBatchImpl(const std::string& name, void* dst,
                        const int64_t* starts, int64_t n,
                        const std::string& as_tenant, bool use_cache) {
  if (!dst || !starts || n < 0) return kErrInvalidArg;
  if (n == 0) return kOk;
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  const int64_t rb = v.row_bytes();
  const int64_t total = v.total_rows();
  char* out = static_cast<char*>(dst);
  trace::ScopedOp top(rank(), trace::kClsGetBatch, -1, n * rb);
  // use_cache == false is the detached cache-FILL entry (background
  // readahead warming, the slowest reads in the system): it must not
  // pollute the tenant's SLO latency surface with traffic the tenant
  // never waited on — same dilution rule as nested timers.
  metrics::OpTimer mtimer(
      use_cache ? &metrics_ : nullptr, trace::kClsGetBatch, -1,
      use_cache && metrics_.enabled()
          ? metrics_.TenantId(as_tenant.empty() ? TenantOfVarName(name)
                                                : as_tenant)
          : 0,
      static_cast<uint64_t>(n * rb));

  // -- Plan -----------------------------------------------------------------
  // Sort (row, output slot) so source-adjacent rows coalesce regardless of
  // request order, duplicates become neighbors (fetch once, replicate
  // after), and every peer's run list comes out offset-sorted — the
  // sequential access pattern the transports and the owner's page cache
  // like best.
  std::vector<std::pair<int64_t, int64_t>> order;  // (row, slot)
  order.reserve(n);
  bool presorted = true;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = starts[i];
    if (row < 0 || row >= total) return top.ret(kErrOutOfRange);
    presorted = presorted && (i == 0 || row >= starts[i - 1]);
    order.emplace_back(row, i);
  }
  // Already-sorted requests (the epoch-readahead engine always submits
  // sorted deduplicated window rows) skip the O(n log n) sort — at
  // window scale (10^5+ rows) the sort otherwise rivals the copy time.
  // Slots ascend with equal rows in input order, so `order` is already
  // in (row, slot) order.
  if (!presorted) std::sort(order.begin(), order.end());

  // Duplicate rows: keep the first occurrence in `order` (compacted in
  // place), remember the rest as post-fetch replications.
  struct Replica {
    int64_t src_slot, dst_slot;
  };
  std::vector<Replica> replicas;
  int64_t uniq = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (uniq > 0 && order[uniq - 1].first == order[i].first) {
      replicas.push_back(Replica{order[uniq - 1].second, order[i].second});
    } else {
      order[uniq++] = order[i];
    }
  }
  order.resize(uniq);

  // Coalesce: rows adjacent in the (sorted) global space that share an
  // owner merge into one run. Owners are found with a forward-moving
  // cursor — sorted rows make the per-row binary search redundant.
  std::vector<Run> runs;
  runs.reserve(uniq);
  int cursor = 0;  // owner of the previous row; owners are nondecreasing
  for (int64_t i = 0; i < uniq; ++i) {
    const int64_t row = order[i].first;
    while (cursor < world() && row >= v.cum[cursor]) ++cursor;
    const int64_t shard_begin = cursor == 0 ? 0 : v.cum[cursor - 1];
    const int64_t off = (row - shard_begin) * rb;
    if (!runs.empty()) {
      Run& last = runs.back();
      if (last.target == cursor &&
          last.offset + last.nrows * rb == off) {
        last.direct = last.direct &&
            order[i].second == order[i - 1].second + 1;
        ++last.nrows;
        continue;
      }
    }
    runs.push_back(Run{cursor, off, 1, i, /*direct=*/true});
  }

  // -- Materialize ----------------------------------------------------------
  // Direct runs read straight into their contiguous dst span. Scattered
  // runs (source-contiguous, dst not) stage through one scratch block and
  // are memcpy'd out afterwards: one big transport segment plus k small
  // host copies beats k transport segments everywhere a segment costs
  // more than a memcpy (syscalls, wire framing, per-iovec kernel walks).
  int64_t scratch_bytes = 0;
  for (const Run& r : runs)
    if (!r.direct) scratch_bytes += r.nrows * rb;
  // new char[] (not vector): every byte is about to be overwritten by
  // the transport reads, and a value-initializing container would pay a
  // full extra memory pass per batch on the hot path.
  std::unique_ptr<char[]> scratch(
      scratch_bytes ? new char[static_cast<size_t>(scratch_bytes)]
                    : nullptr);

  std::map<int, std::vector<ReadOp>> by_peer;
  std::vector<ReadOp> local_ops;
  std::vector<std::pair<const Run*, char*>> fixups;  // scratch scatter list
  int64_t spos = 0;
  int64_t local_runs = 0;
  // One relaxed load gates the whole tier hook: the disabled tree
  // plans, partitions and counts exactly as before.
  const bool cache_on = use_cache && tier_cache_.enabled();
  for (const Run& r : runs) {
    char* rdst;
    if (r.direct) {
      rdst = out + order[r.first].second * rb;
    } else {
      rdst = scratch.get() + spos;
      spos += r.nrows * rb;
      fixups.emplace_back(&r, rdst);
    }
    // Hot-row cache consult, run-by-run, local AND remote legs: a
    // warmed run is one memcpy — a cold-tier page fault or a wire
    // round trip avoided. Misses fall through to the normal path.
    if (cache_on &&
        TierServe(name, v, r.target, r.offset, r.nrows * rb, rdst))
      continue;
    if (r.target == rank()) {
      ++local_runs;
      local_ops.push_back(ReadOp{r.offset, r.nrows * rb, rdst});
    } else {
      by_peer[r.target].push_back(ReadOp{r.offset, r.nrows * rb, rdst});
    }
  }

  {
    std::lock_guard<std::mutex> lock(stats_mu_);
    ++stats_.batches;
    stats_.rows += n;
    stats_.runs += static_cast<int64_t>(runs.size());
    stats_.local_runs += local_runs;
    stats_.peer_lists += static_cast<int64_t>(by_peer.size());
    stats_.dedup_hits += static_cast<int64_t>(replicas.size());
    stats_.scratch_runs += static_cast<int64_t>(fixups.size());
    stats_.scratch_bytes += scratch_bytes;
  }

  // -- Execute --------------------------------------------------------------
  // Local runs in one vectored call (one lock + lookup for the whole
  // batch); ALL remote peers' run lists in one ReadVMulti — concurrency
  // across peers (and across striped connections within a peer) comes
  // from the transport's persistent worker pool, not per-call threads.
  // When a batch has BOTH legs and the local one is big enough to matter,
  // the local copies ride the transport's persistent pool so they overlap
  // the remote transfer instead of delaying its dispatch (a shuffled
  // batch is ~1/world local: at world=4 that's ~0.5 MiB of serial memcpy
  // ahead of every remote fan-out). The task is a flat leaf queued BEFORE
  // ReadVMulti's own leaves, so it cannot deadlock the pool.
  constexpr int64_t kOverlapMinLocalBytes = 64 << 10;
  int64_t local_bytes = 0;
  for (const ReadOp& op : local_ops) local_bytes += op.nbytes;
  WorkerPool* pool = by_peer.empty() ? nullptr : transport_->worker_pool();
  int local_rc = kOk;
  std::unique_ptr<TaskGroup> local_group;
  if (!local_ops.empty()) {
    if (pool && local_bytes >= kOverlapMinLocalBytes) {
      local_group.reset(new TaskGroup(pool));
      local_group->Launch([this, &name, &local_ops, &local_rc]() {
        local_rc = ReadLocalV(name, local_ops.data(),
                              static_cast<int64_t>(local_ops.size()));
      });
    } else {
      local_rc = ReadLocalV(name, local_ops.data(),
                            static_cast<int64_t>(local_ops.size()));
      if (local_rc != kOk) return top.ret(local_rc);
    }
  }
  if (!by_peer.empty()) {
    // Transient failures are retried (store-level for transports without
    // internal retry; the TCP transport retries per leaf); with
    // replication > 1 a peer whose budget exhausts (or whom the
    // heartbeat detector already declared dead) has its runs replanned
    // onto its replica set inside RemoteRead. Retries/failovers are
    // idempotent: every op rewrites its own dst/scratch span. Fatal
    // errors return here — the scratch block and any launched local
    // task are released on every path (unique_ptr + the Wait below).
    int rc = RemoteRead(name, by_peer, as_tenant);
    if (rc != kOk) {
      if (local_group) local_group->Wait();
      return top.ret(rc);
    }
  }
  if (local_group) local_group->Wait();
  if (local_rc != kOk) return top.ret(local_rc);

  // -- Scatter + replicate --------------------------------------------------
  for (const auto& fx : fixups) {
    const Run& r = *fx.first;
    const char* src = fx.second;
    for (int64_t k = 0; k < r.nrows; ++k)
      std::memcpy(out + order[r.first + k].second * rb, src + k * rb, rb);
  }
  for (const Replica& rep : replicas)
    std::memcpy(out + rep.dst_slot * rb, out + rep.src_slot * rb, rb);
  AccountTenantRead(name, n * rb, as_tenant);
  return top.ret(kOk);
}

PlanStats Store::plan_stats() const {
  std::lock_guard<std::mutex> lock(stats_mu_);
  return stats_;
}

void Store::RetryCounters(int64_t out[7]) const { retry_.Snapshot(out); }

void Store::SetRetryDeadline(double seconds) {
  retry_deadline_ns_.store(
      seconds > 0.0 ? static_cast<int64_t>(seconds * 1e9) : 0,
      std::memory_order_relaxed);
  transport_->SetRetryDeadline(seconds);
}

int Store::RetryTransient(const std::function<int()>& call, int target) {
  // A self-retrying transport (TCP) already classified the failure —
  // kErrTransport from it means "fatal before any wire attempt"
  // (endpoint table not set), not a retryable transient. Avoids
  // multiplying the two layers' budgets.
  if (transport_->RetriesInternally()) return call();
  // The suspect hook engages only once failover could act on the
  // verdict (replication/heartbeat in force); the default store stays
  // bit-identical, counters included.
  std::function<bool()> suspect;
  if (target >= 0 && (replication_ > 1 || health_.running()))
    suspect = [this, target]() { return PeerSuspected(target); };
  return RetryTransientLoop(
      retry_, target, /*stop=*/nullptr,
      static_cast<uint64_t>(target + 1), call, /*on_retry=*/{},
      retry_deadline_ns_.load(std::memory_order_relaxed) * 1e-9, suspect);
}

// -- shard replication + transparent read failover ---------------------------

std::string Store::MirrorVarName(const std::string& name, int owner) {
  // \x01 cannot appear in a user variable name that came through the
  // Python layer (and '/'-suffixed ragged parts keep their own names),
  // so mirror names can never collide with primaries.
  return std::string("\x01mirror\x01") + std::to_string(owner) +
         "\x01" + name;
}

int Store::ReplicaSet(int owner, int* out, int cap) const {
  if (!out || owner < 0 || owner >= world()) return kErrInvalidArg;
  int n = 0;
  for (int k = 0; k < replication_ && n < cap; ++k)
    out[n++] = (owner - k + world()) % world();
  return n;
}

int Store::FillMirror(const std::string& name, int owner,
                      const VarInfo& v, int64_t src_seq) {
  const std::string mname = MirrorVarName(name, owner);
  const int64_t shard_begin = owner == 0 ? 0 : v.cum[owner - 1];
  const int64_t nrows = v.cum[owner] - shard_begin;
  const int64_t rb = v.row_bytes();
  const int64_t bytes = nrows * rb;
  {
    // (Re)register the mirror variable. Its cumulative table is
    // local-only ({nrows}): mirrors are never addressed by global row —
    // every consumer reads them by byte offset within the mirrored
    // shard, exactly like the primary's serving paths do.
    std::unique_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(mname);
    if (it == vars_.end()) {
      VarInfo m;
      m.name = mname;
      m.disp = v.disp;
      m.itemsize = v.itemsize;
      m.nrows = nrows;
      m.cum.assign(1, nrows);
      // Mirror fills honor the owning tenant's placement policy: a
      // "cold" tenant's replica coverage lands on NVMe-backed pages
      // instead of pinning RAM (the serving legs are unchanged — the
      // mapping memcpys and streams like any other shard).
      m.base = AllocPlacedShard(mname, bytes);
      if (!m.base) return kErrNoMem;
      m.owned = true;
      const VarInfo& placed =
          vars_.emplace(mname, std::move(m)).first->second;
      transport_->PublishVar(mname, placed.base, placed.shard_bytes());
    } else if (it->second.shard_bytes() != bytes ||
               it->second.disp != v.disp ||
               it->second.itemsize != v.itemsize) {
      return kErrShapeMismatch;  // stale mirror of a re-registered var
    }
  }
  if (bytes == 0 || owner == rank()) return kOk;
  // Pull in bounded ROW-ALIGNED chunks: transport-read into scratch
  // OUTSIDE the lock (a whole-shard read may take a while; readers
  // must not stall behind it), then copy into the mirror under the
  // exclusive lock. Row alignment means each locked copy publishes
  // whole rows, so a concurrent failover reader sees any row either
  // old or new — a row straddling a chunk boundary would otherwise be
  // observable half-refreshed between two chunk copies.
  constexpr int64_t kFillChunk = 8 << 20;
  const int64_t chunk =
      rb >= kFillChunk ? rb : kFillChunk - (kFillChunk % rb);
  std::unique_ptr<char[]> scratch(
      new char[static_cast<size_t>(bytes < chunk ? bytes : chunk)]);
  // Verified fills (DDSTORE_VERIFY=1): each row-aligned chunk is
  // checksummed against the owner's published table BEFORE it is
  // installed — a mirror fill (including a scrub repair) must never
  // propagate corrupt wire bytes into the replica chain. Only engaged
  // when the owner's table exists at exactly the seq this pull is for;
  // any other state (unknown seq, integrity off on the owner) fills
  // unverified, the pre-integrity behavior.
  std::shared_ptr<const integrity::SumTable> vtab;
  bool verify_fill = false;
  if (verify_.load(std::memory_order_relaxed) && src_seq >= 0 &&
      (name.empty() || name[0] != '\x03')) {
    // A cached table at another seq is refetched, not a reason to
    // disengage: every refill after the owner's first Update would
    // otherwise install wire bytes unverified.
    verify_fill = EnsureSumTable(owner, name, nrows, &vtab, false) &&
                  vtab->seq == src_seq;
    if (!verify_fill)
      verify_fill = EnsureSumTable(owner, name, nrows, &vtab, true) &&
                    vtab->seq == src_seq;
  }
  for (int64_t off = 0; off < bytes; off += chunk) {
    const int64_t take = bytes - off < chunk ? bytes - off : chunk;
    auto pull = [&]() {
      return RetryTransient(
          [&]() {
            return transport_->Read(owner, name, off, take, scratch.get());
          },
          owner);
    };
    int rc = pull();
    if (rc != kOk) return rc;
    if (verify_fill) {
      auto chunk_ok = [&]() {
        const int64_t row0 = off / rb, vrows = take / rb;
        for (int64_t r = 0; r < vrows; ++r)
          if (integrity::RowSum(scratch.get() + r * rb, rb, row0 + r,
                                sum_seed_) !=
              vtab->sums[static_cast<size_t>(row0 + r)])
            return false;
        return true;
      };
      if (!chunk_ok()) {
        icnt_.mismatches.fetch_add(1, std::memory_order_relaxed);
        trace::Ev(trace::kVerifyFail, rank(), owner, off / rb, -1);
        rc = pull();  // one re-read, then refuse to install bad bytes
        if (rc != kOk) return rc;
        if (!chunk_ok()) return kErrCorrupt;
      }
    }
    std::unique_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(mname);
    if (it == vars_.end()) return kErrNotFound;  // freed mid-fill
    std::memcpy(it->second.base + off, scratch.get(),
                static_cast<size_t>(take));
  }
  {
    // Record the content version pulled (read BEFORE the pull: a
    // concurrent Update lands as "newer than recorded" and re-pulls at
    // the next fence — the safe direction).
    std::unique_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(mname);
    if (it != vars_.end()) it->second.mirror_src_seq = src_seq;
  }
  failover_.mirror_fills.fetch_add(1, std::memory_order_relaxed);
  failover_.mirror_bytes.fetch_add(bytes, std::memory_order_relaxed);
  return kOk;
}

int Store::Replicate(const std::string& name) {
  if (replication_ <= 1 || world() <= 1) return kOk;
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  for (int k = 1; k < replication_; ++k) {
    const int owner = (rank() + k) % world();
    if (owner == rank()) break;
    int rc = FillMirror(name, owner, v,
                        transport_->ReadVarSeq(owner, name));
    if (rc != kOk) return rc;
  }
  return kOk;
}

void Store::RefreshMirrors(bool force) {
  if (replication_ <= 1 || world() <= 1) return;
  // Snapshot the primary registry first (FillMirror takes the
  // exclusive lock itself).
  std::vector<std::pair<std::string, VarInfo>> prim;
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    for (const auto& kv : vars_)
      // Primaries only: \x01 mirrors and \x03 snapshot/kept-version
      // variables are never themselves mirrored (\x02 tenant shards
      // are real data and replicate like any other).
      if (kv.first.empty() ||
          (kv.first[0] != '\x01' && kv.first[0] != '\x03'))
        prim.emplace_back(kv.first, kv.second);
  }
  for (const auto& nv : prim) {
    for (int k = 1; k < replication_; ++k) {
      const int owner = (rank() + k) % world();
      if (owner == rank()) break;
      if (PeerSuspected(owner)) {
        // The mirror keeps its last good bytes — that copy is exactly
        // what failover is serving for this owner right now.
        failover_.mirror_refresh_skipped.fetch_add(
            1, std::memory_order_relaxed);
        continue;
      }
      // Content-version gate (epoch-fence refreshes only): one tiny
      // control read per mirror instead of a whole-shard pull when the
      // owner has not Update()d since the last pull. Forced refreshes
      // (elastic rebuild) skip the gate — a replacement's restored
      // shard may have ROLLED BACK to its checkpoint at the same seq.
      const int64_t seq = transport_->ReadVarSeq(owner, nv.first);
      if (!force && seq >= 0) {
        bool fresh = false;
        {
          std::shared_lock<std::shared_mutex> lock(mu_);
          auto mit = vars_.find(MirrorVarName(nv.first, owner));
          fresh = mit != vars_.end() &&
                  mit->second.mirror_src_seq == seq;
        }
        if (fresh) continue;
      }
      if (FillMirror(nv.first, owner, nv.second, seq) != kOk)
        failover_.mirror_refresh_skipped.fetch_add(
            1, std::memory_order_relaxed);
    }
  }
}

int64_t Store::UpdateSeqOf(const std::string& name) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  return it == vars_.end() ? -1 : it->second.update_seq;
}

int Store::LastFailedPeer() const {
  if (transport_->RetriesInternally()) return transport_->last_failed_peer();
  int64_t out[7];
  retry_.Snapshot(out);
  return static_cast<int>(out[6]);
}

bool Store::PeerSuspected(int target) const {
  return health_.Suspected(target);
}

void Store::MarkPeerSuspected(int target) { health_.MarkSuspected(target); }

void Store::ClearPeerSuspected(int target) {
  health_.ResetPeer(target);
  // A cleared peer is often a REPLACED peer (elastic recovery): the
  // replacement may serve a different shard generation at the same
  // content version (checkpoint rollback), so cached sum tables for it
  // are no longer trustworthy — verified reads refetch on demand.
  std::lock_guard<std::mutex> lock(sums_mu_);
  for (auto it = sum_cache_.begin(); it != sum_cache_.end();) {
    if (it->first.first == target)
      it = sum_cache_.erase(it);
    else
      ++it;
  }
}

int Store::HealthState(int64_t* out, int cap) const {
  return health_.SuspectFlags(out, cap);
}

void Store::ConfigureHeartbeat(long interval_ms, int suspect_n) {
  if (interval_ms <= 0 || world() <= 1) {
    health_.Stop();
    return;
  }
  const int n = suspect_n > 0 ? suspect_n : HeartbeatSuspectNFromEnv();
  health_.Start(interval_ms, n, [this, interval_ms](int t) {
    return transport_->Ping(t, interval_ms);
  });
}

void Store::FailoverCounters(int64_t out[16]) const {
  for (int i = 0; i < 16; ++i) out[i] = 0;
  out[0] = replication_;
  out[1] = failover_.reads.load(std::memory_order_relaxed);
  out[2] = failover_.runs.load(std::memory_order_relaxed);
  out[3] = failover_.bytes.load(std::memory_order_relaxed);
  out[4] = failover_.suspect_skips.load(std::memory_order_relaxed);
  out[5] = failover_.replica_giveups.load(std::memory_order_relaxed);
  out[6] = failover_.mirror_fills.load(std::memory_order_relaxed);
  out[7] = failover_.mirror_refresh_skipped.load(std::memory_order_relaxed);
  out[8] = failover_.mirror_bytes.load(std::memory_order_relaxed);
  int64_t hb[4];
  health_.Counters(hb);
  out[9] = hb[0];
  out[10] = hb[1];
  out[11] = hb[2];
  out[12] = hb[3];
  out[13] = health_.SuspectedCount();
}

// -- end-to-end data integrity ------------------------------------------------

namespace {
// "\x01mirror\x01<owner>\x01<base>" -> (owner, base).
bool ParseMirrorName(const std::string& mname, int* owner,
                     std::string* base) {
  if (mname.compare(0, 8, "\x01mirror\x01") != 0) return false;
  const size_t end = mname.find('\x01', 8);
  if (end == std::string::npos) return false;
  char* e = nullptr;
  const long o = std::strtol(mname.c_str() + 8, &e, 10);
  if (!e || *e != '\x01') return false;
  *owner = static_cast<int>(o);
  *base = mname.substr(end + 1);
  return true;
}
}  // namespace

int Store::ConfigureIntegrity(int verify, long scrub_ms) {
  if (verify >= 0) {
    verify_.store(verify != 0, std::memory_order_relaxed);
    if (verify) integrity_on_.store(true, std::memory_order_relaxed);
  }
  if (scrub_ms >= 0) {
    if (scrub_ms > 0) integrity_on_.store(true, std::memory_order_relaxed);
    ConfigureScrub(scrub_ms);
  }
  return kOk;
}

int Store::EnsureOwnSums(const std::string& name) {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  if (it == vars_.end()) return kErrNotFound;
  const VarInfo& v = it->second;
  {
    std::lock_guard<std::mutex> sl(sums_mu_);
    auto t = sum_tables_.find(name);
    if (t != sum_tables_.end() && t->second.seq == v.update_seq &&
        static_cast<int64_t>(t->second.sums.size()) == v.nrows)
      return kOk;  // fresh
  }
  // Build under the SHARED registry lock (a concurrent Update holds
  // the exclusive lock, so the bytes hashed here are a consistent
  // version); publish under the leaf sums mutex. Two racing builders
  // compute the same table — harmless.
  integrity::SumTable st;
  st.seq = v.update_seq;
  st.sums.resize(static_cast<size_t>(v.nrows));
  const int64_t rb = v.row_bytes();
  for (int64_t r = 0; r < v.nrows; ++r)
    st.sums[static_cast<size_t>(r)] =
        integrity::RowSum(v.base + r * rb, rb, r, sum_seed_);
  {
    std::lock_guard<std::mutex> sl(sums_mu_);
    sum_tables_[name] = std::move(st);
  }
  icnt_.sums_computed.fetch_add(1, std::memory_order_relaxed);
  icnt_.sums_rows.fetch_add(v.nrows, std::memory_order_relaxed);
  return kOk;
}

int Store::RowSums(const std::string& name, int64_t row0, int64_t count,
                   uint64_t* out, int64_t* seq_out) {
  if (!out || row0 < 0 || count < 0) return kErrInvalidArg;
  if (!integrity_on_.load(std::memory_order_relaxed))
    return kErrNotFound;  // readers treat this as "unverifiable"
  const int rc = EnsureOwnSums(name);
  if (rc != kOk) return rc;
  std::lock_guard<std::mutex> lock(sums_mu_);
  auto it = sum_tables_.find(name);
  if (it == sum_tables_.end()) return kErrNotFound;
  const integrity::SumTable& t = it->second;
  const int64_t n = static_cast<int64_t>(t.sums.size());
  if (row0 > n || count > n - row0) return kErrOutOfRange;
  std::memcpy(out, t.sums.data() + row0,
              static_cast<size_t>(count) * sizeof(uint64_t));
  if (seq_out) *seq_out = t.seq;
  icnt_.sums_served.fetch_add(1, std::memory_order_relaxed);
  return kOk;
}

int64_t Store::CachedSumSeq(int owner, const std::string& name) const {
  std::lock_guard<std::mutex> lock(sums_mu_);
  auto it = sum_cache_.find(std::make_pair(owner, name));
  return it == sum_cache_.end() ? -1 : it->second->seq;
}

void Store::InvalidateSumCache(int owner, const std::string& name) {
  std::lock_guard<std::mutex> lock(sums_mu_);
  sum_cache_.erase(std::make_pair(owner, name));
}

void Store::DropSumsFor(const std::string& name) {
  std::lock_guard<std::mutex> lock(sums_mu_);
  sum_tables_.erase(name);
  for (auto it = sum_cache_.begin(); it != sum_cache_.end();) {
    if (it->first.second == name)
      it = sum_cache_.erase(it);
    else
      ++it;
  }
}

bool Store::EnsureSumTable(int owner, const std::string& name,
                           int64_t rows,
                           std::shared_ptr<const integrity::SumTable>* out,
                           bool refresh) {
  if (rows < 0) return false;
  const auto key = std::make_pair(owner, name);
  if (!refresh) {
    std::lock_guard<std::mutex> lock(sums_mu_);
    auto it = sum_cache_.find(key);
    if (it != sum_cache_.end()) {
      *out = it->second;
      return true;
    }
  }
  auto t = std::make_shared<integrity::SumTable>();
  if (owner == rank()) {
    if (EnsureOwnSums(name) != kOk) return false;
    std::lock_guard<std::mutex> lock(sums_mu_);
    auto o = sum_tables_.find(name);
    if (o == sum_tables_.end()) return false;
    *t = o->second;
  } else {
    // Control-plane fetch, no lock held. Chunked; a seq change
    // mid-fetch means the owner Update()d underneath — restart once
    // (the verify ladder's seq-retry absorbs the rest).
    t->sums.resize(static_cast<size_t>(rows));
    constexpr int64_t kSumChunk = 65536;
    for (int attempt = 0;; ++attempt) {
      bool restart = false;
      t->seq = -1;
      for (int64_t got = 0; got < rows;) {
        const int64_t take =
            rows - got < kSumChunk ? rows - got : kSumChunk;
        int64_t seq = -1;
        if (transport_->ReadRowSums(owner, name, got, take, &seq,
                                    t->sums.data() + got) != kOk)
          return false;
        if (t->seq == -1) {
          t->seq = seq;
        } else if (seq != t->seq) {
          restart = true;
          break;
        }
        got += take;
      }
      if (!restart) break;
      if (attempt >= 1) return false;
    }
  }
  std::lock_guard<std::mutex> lock(sums_mu_);
  sum_cache_[key] = t;
  *out = t;
  return true;
}

int Store::VerifyOps(const std::string& name, int owner,
                     const ReadOp* ops, int64_t n, int64_t* bad_row) {
  if (!name.empty() && name[0] == '\x03')
    return kErrNotFound;  // snapshot/kept views pin OLDER versions: the
                          // current-seq sums cannot judge them
  if (owner < 0 || owner >= world()) return kErrNotFound;
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  const int64_t rb = v.row_bytes();
  if (rb <= 0 || static_cast<int>(v.cum.size()) <= owner)
    return kErrNotFound;
  const int64_t shard_rows =
      v.cum[owner] - (owner == 0 ? 0 : v.cum[owner - 1]);
  std::shared_ptr<const integrity::SumTable> tab;
  if (!EnsureSumTable(owner, name, shard_rows, &tab, false))
    return kErrNotFound;
  icnt_.verified_reads.fetch_add(1, std::memory_order_relaxed);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    const ReadOp& op = ops[i];
    if (op.nbytes <= 0) continue;
    // Every read the store issues is row-aligned; anything else (a
    // hand-crafted byte-offset op) is unverifiable and passes through.
    if (op.offset % rb || op.nbytes % rb) continue;
    const int64_t row0 = op.offset / rb;
    const int64_t rows = op.nbytes / rb;
    if (row0 + rows > static_cast<int64_t>(tab->sums.size())) continue;
    const char* p = static_cast<const char*>(op.dst);
    for (int64_t r = 0; r < rows; ++r) {
      if (integrity::RowSum(p + r * rb, rb, row0 + r, sum_seed_) !=
          tab->sums[static_cast<size_t>(row0 + r)]) {
        if (bad_row) *bad_row = row0 + r;
        return kErrCorrupt;
      }
    }
    total += op.nbytes;
  }
  icnt_.verified_bytes.fetch_add(total, std::memory_order_relaxed);
  return kOk;
}

int Store::VerifyAfterRead(const std::string& name, int owner,
                           const ReadOp* ops, int64_t n,
                           const std::function<int()>& reread) {
  // An owner that DIES mid-ladder (a reread's budget exhausts) keeps
  // the replicated read's failover contract: mark it suspected and
  // serve from the replica chain — dead-owner semantics, bytes
  // unverified by design (mirrors hold the last good pre-fence copy).
  // Returning the bare kErrPeerLost here would strand a read the
  // unverified tree, with a healthy mirror holder, would have served.
  auto reread_failed = [&](int rc) -> int {
    if (rc != kErrPeerLost || replication_ <= 1) return rc;
    MarkPeerSuspected(owner);
    std::vector<ReadOp> v(ops, ops + n);
    return ReadViaReplica(name, owner, v);
  };
  int64_t bad = -1;
  int vc = VerifyOps(name, owner, ops, n, &bad);
  if (vc != kErrCorrupt) return kOk;  // verified or unverifiable
  icnt_.mismatches.fetch_add(1, std::memory_order_relaxed);
  trace::Ev(trace::kVerifyFail, rank(), owner, bad, -1);
  // Rung 1+2 — bracketed re-verification, the seqlock protocol: each
  // round observes the owner's content version, RE-READS the data,
  // refetches the table, then observes the version again. A mismatch
  // is only GENUINE when the whole round sat inside one stable version
  // (seq1 == table.seq == seq2) — anything else is a concurrent
  // Update racing the read, a clean transient. The stable round's
  // re-read doubles as the one primary retry the ladder owes a
  // transient wire flip.
  bool stable = false;
  bool control_ok = true;
  for (int round = 0; round < 4 && !stable && reread; ++round) {
    const int64_t seq1 = transport_->ReadVarSeq(owner, name);
    if (seq1 < 0) {
      // Owner's control plane unreachable: cannot bracket — fall
      // through to the replica rung on the original verdict.
      control_ok = false;
      break;
    }
    const int rc = reread();
    if (rc != kOk) return reread_failed(rc);
    InvalidateSumCache(owner, name);
    bad = -1;
    vc = VerifyOps(name, owner, ops, n, &bad);  // refetches the table
    if (vc != kErrCorrupt) return kOk;
    icnt_.mismatches.fetch_add(1, std::memory_order_relaxed);
    trace::Ev(trace::kVerifyFail, rank(), owner, bad, -1);
    const int64_t seq2 = transport_->ReadVarSeq(owner, name);
    stable = seq2 == seq1 && CachedSumSeq(owner, name) == seq1;
    if (!stable)
      icnt_.seq_retries.fetch_add(1, std::memory_order_relaxed);
  }
  if (vc != kErrCorrupt) return kOk;
  if (!stable && control_ok) {
    // The writer outran every bracket attempt: the delivered bytes ARE
    // a consistent version (the owner's exclusive-locked Update makes
    // each read atomic), just not one the control plane could certify
    // mid-churn. Deliver; verification re-engages the moment the
    // writer pauses. Counted above in verify_seq_retries.
    return kOk;
  }
  if (stable)
    icnt_.primary_retries.fetch_add(1, std::memory_order_relaxed);
  // Rung 3 — the replica chain, every holder's bytes verified.
  if (replication_ > 1) {
    std::vector<ReadOp> v(ops, ops + n);
    const int rc = ReadViaReplica(name, owner, v, /*verify_bytes=*/true);
    if (rc == kOk) {
      icnt_.verify_failovers.fetch_add(1, std::memory_order_relaxed);
      return kOk;
    }
    if (rc != kErrCorrupt && rc != kErrPeerLost) return rc;
    // kErrPeerLost here = no holder readable: the primary's disagreeing
    // bytes remain the only testimony — classified corrupt below.
  }
  icnt_.corrupt_errors.fetch_add(1, std::memory_order_relaxed);
  icnt_.last_corrupt_peer.store(owner, std::memory_order_relaxed);
  return kErrCorrupt;
}

int Store::ScrubOnce() {
  std::vector<std::string> mirrors;
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    for (const auto& kv : vars_)
      if (!kv.first.empty() && kv.first[0] == '\x01')
        mirrors.push_back(kv.first);
  }
  int divergent = 0;
  for (const std::string& m : mirrors) {
    std::string base;
    int owner = -1;
    if (!ParseMirrorName(m, &owner, &base)) continue;
    const int rc = ScrubMirror(m, base, owner);
    if (rc > 0) divergent += rc;
  }
  return divergent;
}

int Store::ScrubMirror(const std::string& mname, const std::string& base,
                       int owner) {
  if (owner < 0 || owner >= world() || owner == rank()) return 0;
  // A suspected owner's mirror IS the failover data right now — and
  // its sums are unreachable anyway.
  if (PeerSuspected(owner)) return 0;
  VarInfo mv;
  int64_t src_seq = -1;
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(mname);
    if (it == vars_.end()) return 0;
    mv = it->second;
    src_seq = it->second.mirror_src_seq;
  }
  const int64_t rb = mv.row_bytes();
  if (rb <= 0 || mv.nrows == 0 || src_seq < 0) return 0;
  // Version gates: an owner that Update()d since the pull makes the
  // mirror legitimately STALE, not corrupt — the next epoch fence
  // re-pulls it. The same gate protects snapshot KEPT copies by
  // construction: scrub walks \x01 mirrors only, so a deliberately
  // older kept version (\x03k) is never "repaired".
  const int64_t cur = transport_->ReadVarSeq(owner, base);
  if (cur < 0 || cur != src_seq) return 0;
  std::shared_ptr<const integrity::SumTable> tab;
  if (!EnsureSumTable(owner, base, mv.nrows, &tab, false)) return 0;
  if (tab->seq != src_seq) {
    if (!EnsureSumTable(owner, base, mv.nrows, &tab, true)) return 0;
    if (tab->seq != src_seq) return 0;
  }
  // Hash the mirror in bounded row-aligned chunks through the locked
  // read path (FillMirror's refresh copies whole rows under the
  // exclusive lock, so every row hashes either old or new).
  constexpr int64_t kScrubChunk = 4 << 20;
  const int64_t chunk_rows = rb >= kScrubChunk ? 1 : kScrubChunk / rb;
  std::unique_ptr<char[]> scratch(
      new char[static_cast<size_t>(chunk_rows * rb)]);
  int64_t divergent_rows = 0;
  for (int64_t r0 = 0; r0 < mv.nrows; r0 += chunk_rows) {
    const int64_t take =
        mv.nrows - r0 < chunk_rows ? mv.nrows - r0 : chunk_rows;
    ReadOp op{r0 * rb, take * rb, scratch.get()};
    if (ReadLocalV(mname, &op, 1) != kOk) return 0;  // freed mid-scrub
    for (int64_t r = 0; r < take; ++r)
      if (integrity::RowSum(scratch.get() + r * rb, rb, r0 + r,
                            sum_seed_) !=
          tab->sums[static_cast<size_t>(r0 + r)])
        ++divergent_rows;
  }
  icnt_.scrub_rows.fetch_add(mv.nrows, std::memory_order_relaxed);
  if (divergent_rows == 0) {
    trace::Ev(trace::kScrub, rank(), mv.nrows, 0, 0);
    return 0;
  }
  icnt_.scrub_divergent.fetch_add(1, std::memory_order_relaxed);
  // Repair: re-pull the whole mirror with the row-aligned FillMirror
  // chunking (itself verified while verify mode is on).
  VarInfo pv;
  int repaired = 0;
  if (GetVarInfo(base, &pv) &&
      FillMirror(base, owner, pv, tab->seq) == kOk) {
    icnt_.scrub_repaired.fetch_add(1, std::memory_order_relaxed);
    repaired = 1;
  }
  trace::Ev(trace::kScrub, rank(), mv.nrows, divergent_rows, repaired);
  return 1;
}

void Store::ConfigureScrub(long interval_ms) {
  // The whole stop+start transition is one critical section: two
  // concurrent configures racing between the join and the assignment
  // would assign over a joinable std::thread (std::terminate).
  std::lock_guard<std::mutex> cfg(scrub_cfg_mu_);
  StopScrubLocked();
  if (interval_ms <= 0 || world() <= 1) return;
  std::lock_guard<std::mutex> lock(scrub_mu_);
  scrub_stop_.store(false, std::memory_order_relaxed);
  scrub_interval_ms_.store(interval_ms, std::memory_order_relaxed);
  scrub_thread_ = std::thread([this] { ScrubLoop(); });
}

void Store::StopScrub() {
  std::lock_guard<std::mutex> cfg(scrub_cfg_mu_);
  StopScrubLocked();
}

void Store::StopScrubLocked() {
  scrub_stop_.store(true, std::memory_order_relaxed);
  // Join OUTSIDE scrub_mu_: the loop takes that mutex for its cursor,
  // and joining while holding it would deadlock a tick that is just
  // reaching the cursor block (scrub_cfg_mu_ stays held — that is the
  // point — and the loop never touches it).
  std::thread t;
  {
    std::lock_guard<std::mutex> lock(scrub_mu_);
    t = std::move(scrub_thread_);
  }
  if (t.joinable()) t.join();
}

void Store::ScrubLoop() {
  while (!scrub_stop_.load(std::memory_order_relaxed)) {
    FaultSleepMs(scrub_interval_ms_.load(std::memory_order_relaxed),
                 &scrub_stop_);
    if (scrub_stop_.load(std::memory_order_relaxed)) return;
    // ONE mirror per tick: the scrub rate is bounded by construction
    // (DDSTORE_SCRUB_MS is the per-mirror cadence, not a duty cycle).
    std::vector<std::string> mirrors;
    {
      std::shared_lock<std::shared_mutex> lock(mu_);
      for (const auto& kv : vars_)
        if (!kv.first.empty() && kv.first[0] == '\x01')
          mirrors.push_back(kv.first);
    }
    if (mirrors.empty()) continue;
    std::string pick;
    {
      std::lock_guard<std::mutex> lock(scrub_mu_);
      auto it = std::upper_bound(mirrors.begin(), mirrors.end(),
                                 scrub_cursor_);
      pick = it == mirrors.end() ? mirrors.front() : *it;
      scrub_cursor_ = pick;
    }
    std::string base;
    int owner = -1;
    if (ParseMirrorName(pick, &owner, &base))
      ScrubMirror(pick, base, owner);
  }
}

void Store::IntegrityStats(int64_t out[16]) const {
  out[0] = verify_.load(std::memory_order_relaxed) ? 1 : 0;
  {
    std::lock_guard<std::mutex> lock(sums_mu_);
    out[1] = static_cast<int64_t>(sum_tables_.size());
  }
  out[2] = icnt_.sums_computed.load(std::memory_order_relaxed);
  out[3] = icnt_.sums_rows.load(std::memory_order_relaxed);
  out[4] = icnt_.sums_served.load(std::memory_order_relaxed);
  out[5] = icnt_.verified_reads.load(std::memory_order_relaxed);
  out[6] = icnt_.verified_bytes.load(std::memory_order_relaxed);
  out[7] = icnt_.mismatches.load(std::memory_order_relaxed);
  out[8] = icnt_.seq_retries.load(std::memory_order_relaxed);
  out[9] = icnt_.primary_retries.load(std::memory_order_relaxed);
  out[10] = icnt_.verify_failovers.load(std::memory_order_relaxed);
  out[11] = icnt_.corrupt_errors.load(std::memory_order_relaxed);
  out[12] = icnt_.scrub_rows.load(std::memory_order_relaxed);
  out[13] = icnt_.scrub_divergent.load(std::memory_order_relaxed);
  out[14] = icnt_.scrub_repaired.load(std::memory_order_relaxed);
  out[15] = icnt_.last_corrupt_peer.load(std::memory_order_relaxed);
}

// -- tiered storage: hot-row cache + cold placement ---------------------------

int Store::ConfigureTierCache(int64_t max_bytes) {
  if (max_bytes < 0) return kOk;
  tier_cache_.Configure(max_bytes);
  // Disabling evicts everything (and returns the tenant-quota
  // charges) — a disabled cache must hold zero RAM.
  if (max_bytes == 0) CacheEvict(-1);
  return kOk;
}

int Store::SetVarTier(const std::string& name, int tier) {
  if (tier < 0 || tier > 1) return kErrInvalidArg;
  std::unique_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  if (it == vars_.end()) return kErrNotFound;
  it->second.tier = tier;
  return kOk;
}

int Store::VarTier(const std::string& name) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  return it == vars_.end() ? kErrNotFound : it->second.tier;
}

int Store::SetTierPlacement(const std::string& tenant, int cold) {
  std::lock_guard<std::mutex> lock(cold_mu_);
  tier_placement_[tenant] = cold ? 1 : 0;
  return kOk;
}

int Store::SetVarFile(const std::string& name, const std::string& path) {
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(name);
    if (it == vars_.end()) return kErrNotFound;
    // O_DIRECT bypasses the page cache: only readonly cold vars may
    // register (see the store.h contract) — a hot var's mmap writes
    // would be invisible to direct reads.
    if (it->second.tier != 1) return kErrInvalidArg;
  }
  if (!ProbeUring().supported) return kErrTransport;
  // Lazy single construction; the exclusive lock only guards the
  // pointer swap (AddFile's open() runs under the reader's own mutex,
  // never under mu_).
  ColdDirectReader* rd;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    if (!cold_direct_)
      cold_direct_ = std::make_unique<ColdDirectReader>();
    rd = cold_direct_.get();
  }
  if (!rd->AddFile(name, path)) return kErrTransport;
  cold_direct_on_.store(true, std::memory_order_release);
  return kOk;
}

void Store::ColdDirectStats(int64_t out[6]) const {
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (!cold_direct_on_.load(std::memory_order_acquire)) return;
  std::shared_lock<std::shared_mutex> lock(mu_);
  if (cold_direct_) cold_direct_->Stats(out);
}

bool Store::ColdPlacementFor(const std::string& name) const {
  if (cold_dir_.empty()) return false;
  const std::string tenant = TenantOfVarName(name);
  std::lock_guard<std::mutex> lock(cold_mu_);
  if (tier_placement_.empty()) return false;  // policy never configured
  auto it = tier_placement_.find(tenant);
  return it != tier_placement_.end() && it->second == 1;
}

char* Store::AllocPlacedShard(const std::string& name, int64_t bytes) {
  if (ColdPlacementFor(name)) {
    void* base = tier::ColdAlloc(cold_dir_, bytes);
    if (base) {
      {
        std::lock_guard<std::mutex> lock(cold_mu_);
        cold_maps_[base] = bytes;
      }
      cold_placed_bytes_.fetch_add(bytes, std::memory_order_relaxed);
      return static_cast<char*>(base);
    }
    // Cold allocation failed (full/absent dir): degrade to RAM — a
    // placement preference must never fail a mirror fill or an
    // Update's copy-on-publish.
  }
  return static_cast<char*>(transport_->AllocShard(name, bytes));
}

void Store::FreeOwnedShard(const std::string& name, void* base) {
  if (base) {
    int64_t len = -1;
    {
      std::lock_guard<std::mutex> lock(cold_mu_);
      auto it = cold_maps_.find(base);
      if (it != cold_maps_.end()) {
        len = it->second;
        cold_maps_.erase(it);
      }
    }
    if (len >= 0) {
      cold_placed_bytes_.fetch_sub(len, std::memory_order_relaxed);
      tier::ColdFree(base, len);
      return;
    }
  }
  transport_->FreeShard(name, base);
}

bool Store::TenantReserveBytes(const std::string& tenant, int64_t bytes,
                               bool* charged) {
  *charged = false;
  if (tenant.empty() &&
      !track_default_tenant_.load(std::memory_order_relaxed))
    return true;  // untracked: nothing to charge (zero-lock default)
  std::lock_guard<std::mutex> lock(tenants_mu_);
  TenantState& t = tenants_[tenant];
  if (t.quota_bytes >= 0 && t.bytes + bytes > t.quota_bytes)
    return false;  // advisory refusal: NOT a quota_rejection (nothing
                   // was admitted or refused registration)
  t.bytes += bytes;
  *charged = true;
  return true;
}

void Store::TenantReleaseBytes(const std::string& tenant, int64_t bytes) {
  std::lock_guard<std::mutex> lock(tenants_mu_);
  auto it = tenants_.find(tenant);
  if (it == tenants_.end()) return;
  it->second.bytes -= bytes;
  if (it->second.bytes < 0) it->second.bytes = 0;
}

void Store::ReleaseTierQuota(
    const std::vector<std::shared_ptr<tier::Entry>>& gone) {
  for (const auto& e : gone)
    if (e->quota_charged > 0 && e->quota_live.exchange(false))
      TenantReleaseBytes(e->tenant, e->quota_charged);
}

bool Store::TierServe(const std::string& name, const VarInfo& v,
                      int target, int64_t offset, int64_t nbytes,
                      void* dst) {
  const int64_t rb = v.row_bytes();
  if (rb <= 0 || nbytes <= 0 || offset % rb || nbytes % rb)
    return false;  // non-row-aligned: unservable, not a miss class
  if (target < 0 || target >= static_cast<int>(v.cum.size()))
    return false;
  const int64_t shard_begin = target == 0 ? 0 : v.cum[target - 1];
  const int64_t row0 = shard_begin + offset / rb;
  if (!tier_cache_.ServeRun(name, row0, nbytes / rb, rb,
                            static_cast<char*>(dst)))
    return false;
  trace::Ev(trace::kCacheHit, rank(), row0, nbytes, target);
  return true;
}

int Store::CachePrefetch(const std::string& name, const int64_t* rows,
                         int64_t n, int64_t window,
                         const std::string& as_tenant) {
  if (!tier_cache_.enabled()) return kOk;  // advisory no-op when off
  if (n == 0) return kOk;  // nothing to warm
  if (!rows || n < 0) return kErrInvalidArg;
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  const int64_t rb = v.row_bytes();
  if (rb <= 0) return kErrInvalidArg;
  tier_cache_.counters().prefetches.fetch_add(
      1, std::memory_order_relaxed);
  const std::string tenant =
      as_tenant.empty() ? TenantOfVarName(name) : as_tenant;
  bool charged = false;
  // Quota-charged cache: the warmed bytes count against the READING
  // tenant's byte budget until eviction. An over-budget tenant's
  // prefetch is skipped (advisory — reads stay correct through the
  // cold path), never classified kErrQuota.
  if (!TenantReserveBytes(tenant, n * rb, &charged)) {
    tier_cache_.counters().over_budget.fetch_add(
        1, std::memory_order_relaxed);
    return kOk;
  }
  // The entry enters the map fully armed (tenant + quota charge): an
  // eviction racing this prefetch must release the charge through the
  // entry it removed, never leak it.
  auto e = tier_cache_.Begin(name, rows, n, rb, window, tenant,
                             charged ? n * rb : 0);
  if (!e) {  // duplicate warm or cache over budget (counted inside)
    if (charged) TenantReleaseBytes(tenant, n * rb);
    return kOk;
  }
  // Detached fill on the async pool: admission-gated and tenant-
  // accounted like any window read, re-entering the batched-read
  // machinery with the cache BYPASSED (a fill must not serve itself).
  // The ticket self-releases at completion, so a peer death mid
  // cold-fill leaves AsyncPending() == 0 and the failed slot freed
  // exactly once (shared_ptr) — the ASan stress block's contract.
  SubmitAsync(
      tenant,
      [this, name, e]() {
        int rc = GetBatchImpl(name, e->buf.get(), e->rows.data(),
                              static_cast<int64_t>(e->rows.size()),
                              e->tenant, /*use_cache=*/false);
        FinishCacheFill(e, rc);
        return rc;
      },
      /*detached=*/true);
  return kOk;
}

void Store::FinishCacheFill(const std::shared_ptr<tier::Entry>& e,
                            int rc) {
  tier_cache_.Commit(e, rc == kOk);
  if (rc != kOk && e->quota_charged > 0 &&
      e->quota_live.exchange(false))
    TenantReleaseBytes(e->tenant, e->quota_charged);
  trace::Ev(trace::kCacheFill, rank(), e->window,
            rc == kOk ? e->bytes() : 0, rc);
}

int Store::CacheEvict(int64_t window) {
  std::vector<std::shared_ptr<tier::Entry>> gone;
  const int n = tier_cache_.Evict(window, &gone);
  ReleaseTierQuota(gone);
  // Traced OUTSIDE the cache's leaf mutex (the emit-site discipline).
  for (const auto& e : gone)
    trace::Ev(trace::kCacheEvict, rank(), e->window, e->bytes(), 0);
  return n;
}

void Store::TieringStats(int64_t out[16]) const {
  int64_t c[13];
  tier_cache_.Stats(c);
  out[0] = tier_cache_.max_bytes();
  out[1] = c[11];  // charged cache bytes (gauge)
  out[2] = c[12];  // live entries (gauge)
  int64_t cold_vars = 0, cold_bytes = 0;
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    for (const auto& kv : vars_)
      if (kv.second.tier == 1) {
        ++cold_vars;
        cold_bytes += kv.second.shard_bytes();
      }
  }
  out[3] = cold_vars;
  out[4] =
      cold_bytes + cold_placed_bytes_.load(std::memory_order_relaxed);
  for (int i = 0; i < 11; ++i) out[5 + i] = c[i];
}

// -- tenant quotas, shares, accounting ----------------------------------------

int Store::SetTenantQuota(const std::string& tenant, int64_t max_bytes,
                          int64_t max_vars) {
  {
    std::lock_guard<std::mutex> lock(tenants_mu_);
    TenantState& t = tenants_[tenant];
    t.quota_bytes = max_bytes;
    t.quota_vars = max_vars;
  }
  if (tenant.empty()) track_default_tenant_.store(true);
  return kOk;
}

int Store::SetTenantShare(const std::string& tenant, int share) {
  if (share < 1) return kErrInvalidArg;
  {
    std::lock_guard<std::mutex> lock(tenants_mu_);
    tenants_[tenant];  // the ledger knows every configured tenant
  }
  if (tenant.empty()) track_default_tenant_.store(true);
  std::lock_guard<std::mutex> lock(async_mu_);
  auto it = async_shares_.find(tenant);
  if (it != async_shares_.end()) {
    async_share_total_ -= it->second;
    it->second = share;
  } else {
    async_shares_[tenant] = share;
  }
  async_share_total_ += share;
  PumpAsyncLocked();  // a raised share may admit deferred reads now
  return kOk;
}

int Store::TenantReserve(const std::string& tenant, int64_t bytes) {
  bool rejected = false;
  {
    std::lock_guard<std::mutex> lock(tenants_mu_);
    TenantState& t = tenants_[tenant];
    if ((t.quota_bytes >= 0 && t.bytes + bytes > t.quota_bytes) ||
        (t.quota_vars >= 0 && t.vars + 1 > t.quota_vars)) {
      ++t.quota_rejections;
      rejected = true;
    } else {
      t.bytes += bytes;
      ++t.vars;
    }
  }
  if (rejected) {
    // Traced OUTSIDE tenants_mu_ (a leaf DDS_NO_BLOCKING mutex must
    // never nest the trace registry's). An admission refusal is one of
    // the flight recorder's trigger moments.
    trace::Ev(trace::kQuotaReject, rank(), bytes, 0, 0);
    trace::Flight(trace::kReasonQuota, rank());
    return kErrQuota;
  }
  return kOk;
}

void Store::TenantRelease(const std::string& tenant, int64_t bytes) {
  std::lock_guard<std::mutex> lock(tenants_mu_);
  auto it = tenants_.find(tenant);
  if (it == tenants_.end()) return;
  it->second.bytes -= bytes;
  if (it->second.bytes < 0) it->second.bytes = 0;
  if (it->second.vars > 0) --it->second.vars;
}

void Store::AccountTenantRead(const std::string& name, int64_t nbytes,
                              const std::string& as_tenant) {
  std::string tenant;
  if (!as_tenant.empty()) {
    // A named READING tenant always ledgers its own traffic — even of
    // the shared default namespace (the headline attach() use case).
    tenant = as_tenant;
  } else {
    if (name.empty() ||
        (name[0] != '\x02' && name[0] != '\x03' &&
         !track_default_tenant_.load(std::memory_order_relaxed)))
      return;  // default path: zero locks
    tenant = TenantOfVarName(name);
    if (tenant.empty() &&
        !track_default_tenant_.load(std::memory_order_relaxed))
      return;
  }
  std::lock_guard<std::mutex> lock(tenants_mu_);
  TenantState& t = tenants_[tenant];
  t.read_bytes += nbytes;
  ++t.reads;
}

void Store::AccountTenantServe(const std::string& name, int64_t nbytes) {
  if (name.empty() ||
      (name[0] != '\x01' && name[0] != '\x02' && name[0] != '\x03' &&
       !track_default_tenant_.load(std::memory_order_relaxed)))
    return;
  const std::string tenant = TenantOfVarName(name);
  if (tenant.empty() &&
      !track_default_tenant_.load(std::memory_order_relaxed))
    return;
  std::lock_guard<std::mutex> lock(tenants_mu_);
  TenantState& t = tenants_[tenant];
  t.served_bytes += nbytes;
  ++t.served_reads;
}

int Store::TenantNames(char* out, int cap) const {
  if (!out || cap <= 0) return kErrInvalidArg;
  std::vector<std::string> names;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    for (const auto& kv : async_shares_) names.push_back(kv.first);
  }
  {
    std::lock_guard<std::mutex> lock(tenants_mu_);
    for (const auto& kv : tenants_)
      if (std::find(names.begin(), names.end(), kv.first) == names.end())
        names.push_back(kv.first);
  }
  std::sort(names.begin(), names.end());
  // The DEFAULT tenant "" (sorted first) is encoded as a LEADING
  // separator: a CSV of plain labels cannot otherwise represent it,
  // and a configured default tenant's ledger row must stay visible to
  // Python (metrics deltas, the planner's share split).
  std::string csv;
  size_t start = 0;
  if (!names.empty() && names[0].empty()) {
    csv = ",";
    start = 1;
  }
  for (size_t i = start; i < names.size(); ++i) {
    if (i > start) csv += ',';
    csv += names[i];
  }
  const size_t n = csv.size() < static_cast<size_t>(cap - 1)
                       ? csv.size()
                       : static_cast<size_t>(cap - 1);
  std::memcpy(out, csv.data(), n);
  out[n] = '\0';
  return static_cast<int>(n);
}

int Store::TenantCounters(const std::string& tenant,
                          int64_t out[16]) const {
  for (int i = 0; i < 16; ++i) out[i] = 0;
  out[0] = out[1] = -1;  // quota gauges: unlimited by default
  {
    std::lock_guard<std::mutex> lock(tenants_mu_);
    auto it = tenants_.find(tenant);
    if (it != tenants_.end()) {
      const TenantState& t = it->second;
      out[0] = t.quota_bytes;
      out[1] = t.quota_vars;
      out[2] = t.bytes;
      out[3] = t.vars;
      out[4] = t.quota_rejections;
      out[5] = t.read_bytes;
      out[6] = t.reads;
      out[7] = t.served_bytes;
      out[8] = t.served_reads;
    }
  }
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    auto a = async_tenant_admitted_.find(tenant);
    if (a != async_tenant_admitted_.end()) out[9] = a->second;
    auto d = async_tenant_deferred_.find(tenant);
    if (d != async_tenant_deferred_.end()) out[10] = d->second;
    // 0 = no share configured for this tenant (the gate then treats it
    // as implicit weight 1 against the CONFIGURED total) — reporting
    // the implicit 1 here would make "configured at weight 1" and
    // "never configured" indistinguishable to the planner.
    auto s = async_shares_.find(tenant);
    out[12] = s != async_shares_.end() ? s->second : 0;
  }
  {
    // Active snapshot pins this tenant's handles hold on THIS rank.
    std::shared_lock<std::shared_mutex> lock(mu_);
    for (const auto& kv : snap_pins_)
      if (kv.second.tenant == tenant) ++out[11];
  }
  return kOk;
}

// -- read-only snapshot epochs ------------------------------------------------

std::string Store::SnapVarName(int64_t snap_id, const std::string& name) {
  return std::string("\x03s\x03") + std::to_string(snap_id) + "\x03" +
         name;
}

std::string Store::KeepVarName(int64_t seq, const std::string& name) {
  return std::string("\x03k\x03") + std::to_string(seq) + "\x03" + name;
}

bool Store::ParseSnapName(const std::string& name, int64_t* id,
                          std::string* base) {
  if (name.compare(0, 3, "\x03s\x03") != 0) return false;
  const size_t end = name.find('\x03', 3);
  if (end == std::string::npos) return false;
  char* e = nullptr;
  const long long v = std::strtoll(name.c_str() + 3, &e, 10);
  if (!e || *e != '\x03') return false;
  *id = v;
  *base = name.substr(end + 1);
  return true;
}

std::map<std::string, VarInfo>::const_iterator Store::ResolveMetaLocked(
    const std::string& name) const {
  auto it = vars_.find(name);
  if (it != vars_.end()) return it;
  int64_t id;
  std::string base;
  if (!ParseSnapName(name, &id, &base)) return it;
  return vars_.find(base);
}

std::map<std::string, VarInfo>::const_iterator Store::ResolveDataLocked(
    const std::string& name) const {
  auto it = vars_.find(name);
  if (it != vars_.end()) return it;  // plain/mirror/keep: zero overhead
  int64_t id;
  std::string base;
  if (!ParseSnapName(name, &id, &base)) return it;  // truly unknown
  auto bit = vars_.find(base);
  auto pit = snap_pins_.find(id);
  if (pit == snap_pins_.end() || bit == vars_.end())
    return bit;  // snapshot released (reader detached mid-read): the
                 // primary serves — the kept copy may already be freed
  auto vp = pit->second.pins.find(base);
  if (vp == pit->second.pins.end())
    return bit;  // var registered after the pin: current bytes
  if (bit->second.update_seq == vp->second) return bit;  // unchanged
  auto kit = vars_.find(KeepVarName(vp->second, base));
  return kit != vars_.end() ? kit : bit;
}

void Store::MaybeKeepLocked(const std::string& name, const VarInfo& v) {
  if (snap_pins_.empty()) return;  // default path: one empty() check
  bool pinned = false;
  for (const auto& kv : snap_pins_) {
    auto p = kv.second.pins.find(name);
    if (p != kv.second.pins.end() && p->second == v.update_seq) {
      pinned = true;
      break;
    }
  }
  if (!pinned) return;
  const std::string kname = KeepVarName(v.update_seq, name);
  if (vars_.count(kname)) return;  // this version is already kept
  const int64_t bytes = v.shard_bytes();
  VarInfo k;
  k.name = kname;
  k.disp = v.disp;
  k.itemsize = v.itemsize;
  k.nrows = v.nrows;
  k.cum.assign(1, v.nrows);  // local-only: kept copies are addressed by
                             // byte offset, exactly like mirrors
  // Kept copies honor the placement policy too: a snapshot epoch over
  // a "cold" tenant's data keeps its pinned versions on the cold tier.
  k.base = AllocPlacedShard(kname, bytes);
  if (!k.base) return;  // no RAM for the copy: snapshot readers of this
                        // shard degrade to current bytes, never a
                        // failed Update
  if (bytes > 0) std::memcpy(k.base, v.base, static_cast<size_t>(bytes));
  k.owned = true;
  vars_.emplace(kname, std::move(k));
  ++kept_versions_;
  kept_bytes_ += bytes;
}

void Store::FreeKeepsLocked(const std::string& name) {
  for (auto it = vars_.begin(); it != vars_.end();) {
    bool is_keep = it->first.compare(0, 3, "\x03k\x03") == 0;
    if (is_keep) {
      const size_t end = it->first.find('\x03', 3);
      is_keep = end != std::string::npos &&
                it->first.compare(end + 1, std::string::npos, name) == 0;
    }
    if (!is_keep) {
      ++it;
      continue;
    }
    if (it->second.owned) FreeOwnedShard(it->first, it->second.base);
    kept_bytes_ -= it->second.shard_bytes();
    --kept_versions_;
    it = vars_.erase(it);
  }
}

int Store::PinSnapshot(int64_t snap_id, const std::string& tenant) {
  {
    // The acquiring tenant becomes ledger-visible on every rank it
    // pinned (the snapshot_pins gauge lives in its row). Sequential
    // locks — tenants_mu_ stays a leaf, never nested under mu_.
    std::lock_guard<std::mutex> tl(tenants_mu_);
    tenants_[tenant];
  }
  std::unique_lock<std::shared_mutex> lock(mu_);
  SnapPin sp;
  sp.tenant = tenant;
  sp.created_ns = metrics::OpTimer::NowNs();
  for (const auto& kv : vars_) {
    if (kv.first.empty() || kv.first[0] == '\x01' ||
        kv.first[0] == '\x03')
      continue;  // mirrors/keeps are never pinned themselves
    // Pin the shared default namespace plus the ACQUIRING tenant's own
    // variables only: another tenant's namespace is unreadable through
    // this handle (cross-tenant reads are refused), so pinning it
    // would only materialize kept copies of shards nobody can read —
    // RAM cost scaling with unrelated tenants' update traffic.
    if (kv.first[0] == '\x02' && TenantOfVarName(kv.first) != tenant)
      continue;
    sp.pins[kv.first] = kv.second.update_seq;
  }
  snap_pins_[snap_id] = std::move(sp);
  return kOk;
}

int Store::UnpinSnapshot(int64_t snap_id) {
  std::unique_lock<std::shared_mutex> lock(mu_);
  auto it = snap_pins_.find(snap_id);
  if (it == snap_pins_.end()) return kOk;  // idempotent: double release
  const std::map<std::string, int64_t> pins = std::move(it->second.pins);
  snap_pins_.erase(it);
  for (const auto& pv : pins) {
    bool still_pinned = false;
    for (const auto& kv : snap_pins_) {
      auto p = kv.second.pins.find(pv.first);
      if (p != kv.second.pins.end() && p->second == pv.second) {
        still_pinned = true;
        break;
      }
    }
    if (still_pinned) continue;
    auto kit = vars_.find(KeepVarName(pv.second, pv.first));
    if (kit == vars_.end()) continue;
    // Freed exactly once, under the exclusive lock: an in-flight read
    // serving from this copy holds the shared lock for its whole
    // memcpy, so the free waits it out; the next read resolves to the
    // primary.
    if (kit->second.owned)
      FreeOwnedShard(kit->first, kit->second.base);
    kept_bytes_ -= kit->second.shard_bytes();
    --kept_versions_;
    vars_.erase(kit);
  }
  return kOk;
}

int64_t Store::SnapshotAcquire(const std::string& tenant) {
  int64_t id;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    id = (static_cast<int64_t>(rank()) << 32) | ++snap_counter_;
  }
  int rc = PinSnapshot(id, tenant);
  if (rc != kOk) return rc;
  for (int t = 0; t < world(); ++t) {
    if (t == rank()) continue;
    rc = transport_->SnapshotControl(t, id, /*pin=*/true, tenant);
    if (rc != kOk) {
      // All-or-nothing: a snapshot that silently missed an owner would
      // serve torn epochs. Roll back what was placed (the partial-pin
      // unwind). A mid-placement death feeds the suspect registry so
      // the unpins below — and every later control op — short-circuit
      // the corpse instead of re-burning its control budget. A LIVE
      // peer whose unpin transiently fails (control chaos) gets one
      // more pass: a stranded pin would hold copy-on-publish RAM for
      // a snapshot nobody owns until that peer's store closes.
      if (rc == kErrPeerLost) MarkPeerSuspected(t);
      std::vector<int> failed;
      for (int u = 0; u < t; ++u)
        if (u != rank() &&
            transport_->SnapshotControl(u, id, /*pin=*/false,
                                        tenant) != kOk)
          failed.push_back(u);
      for (int u : failed)
        transport_->SnapshotControl(u, id, /*pin=*/false, tenant);
      UnpinSnapshot(id);
      return rc;
    }
  }
  return id;
}

int Store::SnapshotRelease(int64_t snap_id) {
  // Best effort on peers: a dead owner's pins died with it, and the
  // release must still reclaim every local kept version.
  for (int t = 0; t < world(); ++t)
    if (t != rank())
      transport_->SnapshotControl(t, snap_id, /*pin=*/false,
                                  std::string());
  return UnpinSnapshot(snap_id);
}

void Store::SnapshotCounters(int64_t out[4]) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  out[0] = static_cast<int64_t>(snap_pins_.size());
  out[1] = kept_versions_;
  out[2] = kept_bytes_;
  out[3] = snap_reclaimed_.load(std::memory_order_relaxed);
}

int Store::ReadViaReplica(const std::string& name, int owner,
                          const std::vector<ReadOp>& ops,
                          bool verify_bytes) {
  // Snapshot-scoped (and kept-version) reads NEVER fail over: mirrors
  // are registered for the base name only and hold the owner's CURRENT
  // bytes, so serving one would silently violate the version pin.
  // Stability over availability — the reader gets kErrPeerLost and can
  // detach/re-attach for a fresh snapshot (README "Multi-tenant
  // service", interaction with R>1).
  if (!name.empty() && name[0] == '\x03') {
    failover_.replica_giveups.fetch_add(1, std::memory_order_relaxed);
    return kErrPeerLost;
  }
  int64_t bytes = 0;
  for (const ReadOp& op : ops) bytes += op.nbytes;
  bool corrupt_seen = false;
  for (int k = 1; k < replication_; ++k) {
    const int h = (owner - k + world()) % world();
    if (h == owner) break;
    const std::string mname = MirrorVarName(name, owner);
    int rc;
    if (h == rank()) {
      rc = ReadLocalV(mname, ops.data(),
                      static_cast<int64_t>(ops.size()));
      if (rc == kErrNotFound) continue;  // mirror never built here
    } else {
      if (PeerSuspected(h)) continue;
      PeerReadV rq{h, ops.data(), static_cast<int64_t>(ops.size())};
      rc = RetryTransient(
          [&]() { return transport_->ReadVMulti(mname, &rq, 1); }, h);
      if (rc == kErrPeerLost) {
        MarkPeerSuspected(h);
        continue;
      }
      if (rc == kErrNotFound) continue;  // holder carries no mirror
    }
    if (rc == kOk && verify_bytes) {
      // Corruption reroute: this holder's bytes must agree with the
      // owner's published sums too — a mirror that replicated the
      // corruption (or rotted independently) must not silently serve.
      int64_t bad = -1;
      const int vrc = VerifyOps(name, owner, ops.data(),
                                static_cast<int64_t>(ops.size()), &bad);
      if (vrc == kErrCorrupt) {
        icnt_.mismatches.fetch_add(1, std::memory_order_relaxed);
        trace::Ev(trace::kVerifyFail, rank(), owner, bad, h);
        corrupt_seen = true;
        continue;  // idempotent: the next holder rewrites the same dst
      }
    }
    if (rc == kOk) {
      failover_.reads.fetch_add(1, std::memory_order_relaxed);
      failover_.runs.fetch_add(static_cast<int64_t>(ops.size()),
                               std::memory_order_relaxed);
      failover_.bytes.fetch_add(bytes, std::memory_order_relaxed);
      // Replica-rerouted op, under the read's span: the dead owner and
      // the holder that served instead, for the postmortem span tree.
      trace::Ev(trace::kFailover, rank(), owner, h,
                static_cast<int64_t>(ops.size()));
      return kOk;
    }
    return rc;  // fatal (out-of-range against the mirror, ...)
  }
  if (corrupt_seen) return kErrCorrupt;  // every readable holder disagreed
  // Primary AND every mirror holder gone: the bounded "rows truly
  // lost" signal — elastic.recover is the next rung.
  failover_.replica_giveups.fetch_add(1, std::memory_order_relaxed);
  return kErrPeerLost;
}

int Store::RemoteRead(const std::string& name,
                      const std::map<int, std::vector<ReadOp>>& by_peer,
                      const std::string& as_tenant) {
  if (by_peer.empty()) return kOk;
  // Verify hook shared by both branches: re-verify one peer's op list
  // with a single-peer retried re-read as the ladder's `reread`.
  auto verify_peer = [&](int peer, const std::vector<ReadOp>& ops) {
    auto reread = [&, peer]() {
      PeerReadV rq{peer, ops.data(), static_cast<int64_t>(ops.size())};
      return RetryTransient(
          [&]() { return transport_->ReadVMulti(name, &rq, 1, as_tenant); },
          peer);
    };
    return VerifyAfterRead(name, peer, ops.data(),
                           static_cast<int64_t>(ops.size()), reread);
  };
  if (replication_ <= 1) {
    // Exactly the pre-replication remote leg: one retried ReadVMulti,
    // kErrPeerLost surfacing unchanged (byte- and counter-identical).
    std::vector<PeerReadV> reqs;
    reqs.reserve(by_peer.size());
    for (const auto& kv : by_peer)
      reqs.push_back(PeerReadV{kv.first, kv.second.data(),
                               static_cast<int64_t>(kv.second.size())});
    const int target = reqs.size() == 1 ? reqs[0].target : -1;
    int rc = RetryTransient(
        [&]() {
          return transport_->ReadVMulti(name, reqs.data(),
                                        static_cast<int64_t>(reqs.size()),
                                        as_tenant);
        },
        target);
    if (rc != kOk || !verify_.load(std::memory_order_relaxed)) return rc;
    for (const auto& kv : by_peer) {
      rc = verify_peer(kv.first, kv.second);
      if (rc != kOk) return rc;
    }
    return kOk;
  }
  // Failover plan: suspected peers route straight to their replicas
  // (zero deadline burn); the rest issue normally; a kErrPeerLost
  // verdict names the dead peer, marks it suspected, and the loop
  // replans — only ITS ops move to the replica chain, everything else
  // re-reads idempotently. Bounded by world() iterations (each round
  // permanently retires at least one peer into the suspect set).
  std::map<int, std::vector<ReadOp>> pending(by_peer);
  for (int round = 0; round <= world(); ++round) {
    std::vector<PeerReadV> go;
    for (auto& kv : pending) {
      if (PeerSuspected(kv.first)) {
        failover_.suspect_skips.fetch_add(1, std::memory_order_relaxed);
        int rc = ReadViaReplica(name, kv.first, kv.second);
        if (rc != kOk) return rc;
      } else {
        go.push_back(PeerReadV{kv.first, kv.second.data(),
                               static_cast<int64_t>(kv.second.size())});
      }
    }
    if (go.empty()) return kOk;
    const int target = go.size() == 1 ? go[0].target : -1;
    int rc = RetryTransient(
        [&]() {
          return transport_->ReadVMulti(name, go.data(),
                                        static_cast<int64_t>(go.size()),
                                        as_tenant);
        },
        target);
    if (rc == kOk) {
      if (verify_.load(std::memory_order_relaxed)) {
        // Verify every primary-served list (replica-served ops were
        // either verified inside the corrupt reroute or are the dead-
        // owner path, which deliberately serves last-good bytes).
        for (const PeerReadV& g : go) {
          auto pit = pending.find(g.target);
          if (pit == pending.end()) continue;
          const int vrc = verify_peer(g.target, pit->second);
          if (vrc != kOk) return vrc;
        }
      }
      return kOk;
    }
    if (rc != kErrPeerLost) return rc;  // fatal data error / teardown
    int dead = target >= 0 ? target : LastFailedPeer();
    bool named = false;
    for (const PeerReadV& g : go) named = named || g.target == dead;
    // A stale/unset diagnostic cannot stall the plan: retire the first
    // still-pending peer (idempotent re-reads make this safe; a live
    // peer wrongly retired is served by its replica, and the heartbeat
    // un-suspects it at the next successful ping).
    if (!named) dead = go[0].target;
    MarkPeerSuspected(dead);
    std::map<int, std::vector<ReadOp>> next;
    for (const PeerReadV& g : go)
      next.emplace(g.target,
                   std::vector<ReadOp>(g.ops, g.ops + g.n));
    pending.swap(next);
  }
  failover_.replica_giveups.fetch_add(1, std::memory_order_relaxed);
  return kErrPeerLost;
}

int Store::AsyncWidth() const {
  const int w = async_width_override_.load(std::memory_order_relaxed);
  if (w >= 1) return w < kAsyncPoolCap ? w : kAsyncPoolCap;
  return async_default_;
}

int Store::SetAsyncWidth(int n) {
  async_width_override_.store(n >= 1 ? n : 0, std::memory_order_relaxed);
  // A raise must admit reads already waiting for a slot.
  std::lock_guard<std::mutex> lock(async_mu_);
  PumpAsyncLocked();
  return kOk;
}

int Store::TenantLimitLocked(const std::string& tenant, int width) const {
  if (async_shares_.empty()) return width;  // no QoS configured
  auto it = async_shares_.find(tenant);
  const int share = it == async_shares_.end() ? 1 : it->second;
  const int64_t total = async_share_total_ > 0 ? async_share_total_ : 1;
  int lim = static_cast<int>(
      (static_cast<int64_t>(width) * share) / total);
  if (lim < 1) lim = 1;  // every tenant always makes progress
  return lim > width ? width : lim;
}

void Store::PumpAsyncLocked() {
  // One forward scan admitting every deferred read whose tenant is
  // under its share bound — not strictly FIFO across tenants: a
  // backlogged tenant at its bound must not head-of-line-block the
  // others (that is the whole point of the shares). A single pass is
  // exact: admissions only RAISE running counts, so an entry skipped
  // at its tenant's bound cannot become admissible later in the same
  // pump — no restart-from-front needed (a deep throttled backlog at
  // the head would otherwise make each pump O(backlog) per admission
  // while holding async_mu_).
  if (!async_pool_) return;
  const int width = AsyncWidth();
  for (auto it = async_deferred_.begin();
       it != async_deferred_.end() && async_running_ < width;) {
    if (async_tenant_running_[it->tenant] >=
        TenantLimitLocked(it->tenant, width)) {
      ++it;
      continue;
    }
    ++async_running_;
    ++async_tenant_running_[it->tenant];
    ++async_tenant_admitted_[it->tenant];
    async_pool_->Submit(std::move(it->task));
    it = async_deferred_.erase(it);
  }
}

int64_t Store::SubmitAsync(const std::string& tenant,
                           std::function<int()> fn, bool detached) {
  auto st = std::make_shared<AsyncState>();
  int64_t ticket;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    if (!async_pool_) {
      // The pool's thread cap is fixed and generous (threads spawn
      // lazily); the ADMISSION width — how many reads run at once,
      // i.e. how many window fetches may contend for the transport's
      // lanes/cores — is enforced below via async_running_, so the
      // scheduler can change it at runtime (SetAsyncWidth). One window
      // in flight is the readahead steady state (the ring keeps window
      // N+1 fetching while N is consumed); extra width absorbs a
      // co-variable (labels) and deeper rings. Each read's lane
      // fan-out happens INSIDE the transport pool.
      async_pool_.reset(new WorkerPool(kAsyncPoolCap));
    }
    ticket = next_ticket_++;
    async_[ticket] = st;
    auto task = [this, tenant, fn = std::move(fn), st, ticket,
                 detached]() {
      int rc = fn();
      {
        std::lock_guard<std::mutex> lock(st->mu);
        st->rc = rc;
        st->done_mono_s = MonoSeconds();
        st->done = true;
      }
      st->cv.notify_all();
      // Free the admission slot and start the next deferred read.
      // async_pool_ is stable once created (only DrainAsync moves it,
      // and callers must not race teardown with new issues).
      std::lock_guard<std::mutex> lock(async_mu_);
      --async_running_;
      auto rit = async_tenant_running_.find(tenant);
      if (rit != async_tenant_running_.end() && rit->second > 0)
        --rit->second;
      // A detached ticket (cache fill) self-releases: no caller will
      // ever wait on it, and a leaked ticket would read as a pending
      // async leak. Idempotent vs DrainAsync's wholesale clear.
      if (detached) async_.erase(ticket);
      PumpAsyncLocked();
    };
    if (async_running_ < AsyncWidth() &&
        async_tenant_running_[tenant] <
            TenantLimitLocked(tenant, AsyncWidth())) {
      ++async_running_;
      ++async_tenant_running_[tenant];
      ++async_tenant_admitted_[tenant];
      async_pool_->Submit(std::move(task));
    } else {
      ++async_tenant_deferred_[tenant];
      async_deferred_.push_back(DeferredRead{tenant, std::move(task)});
    }
  }
  return ticket;
}

int64_t Store::GetBatchAsync(const std::string& name, void* dst,
                             const int64_t* starts, int64_t n,
                             const std::string& as_tenant) {
  if (!dst || !starts || n < 0) return kErrInvalidArg;
  std::vector<int64_t> idx(starts, starts + n);
  const std::string tenant =
      as_tenant.empty() ? TenantOfVarName(name) : as_tenant;
  // Span minted at ISSUE time, carried into the pool body: the op's
  // begin→end brackets issue→completion (the readahead overlap the
  // trace exists to show); the inner GetBatch joins the same span.
  uint64_t tspan = 0;
  int64_t tbytes = 0;
  if (trace::Enabled() || metrics_.enabled()) {
    VarInfo v;
    tbytes = GetVarInfo(name, &v) ? n * v.row_bytes() : 0;
  }
  if (trace::Enabled()) {
    tspan = trace::NewSpan(rank());
    trace::Emit(trace::kOpBegin, tspan, rank(), trace::kClsAsyncBatch,
                -1, tbytes);
  }
  // ddmetrics async bracket: the sample's latency is ISSUE ->
  // completion (queueing included — the number a reader's SLO sees),
  // so t0 is captured here and carried into the pool body's timer.
  const uint64_t mq0 =
      metrics_.enabled() ? metrics::OpTimer::NowNs() : 0;
  const int mtid = metrics_.enabled() ? metrics_.TenantId(tenant) : 0;
  return SubmitAsync(tenant, [this, name, dst, tenant, tspan, tbytes,
                              mq0, mtid, idx = std::move(idx)]() {
    metrics::OpTimer mtimer(&metrics_, trace::kClsAsyncBatch, -1, mtid,
                            static_cast<uint64_t>(tbytes), mq0);
    trace::ScopedSpan sp(tspan);
    int rc = GetBatch(name, dst, idx.data(),
                      static_cast<int64_t>(idx.size()), tenant);
    if (tspan)
      trace::Emit(trace::kOpEnd, tspan, rank(), trace::kClsAsyncBatch,
                  rc, tbytes);
    return rc;
  });
}

int64_t Store::ReadRunsAsync(const std::string& name, void* dst,
                             const int64_t* targets,
                             const int64_t* src_off,
                             const int64_t* dst_off,
                             const int64_t* nbytes, int64_t nruns,
                             const std::string& as_tenant) {
  if (!dst || !targets || !src_off || !dst_off || !nbytes || nruns < 0)
    return kErrInvalidArg;
  std::vector<int64_t> t(targets, targets + nruns);
  std::vector<int64_t> so(src_off, src_off + nruns);
  std::vector<int64_t> dof(dst_off, dst_off + nruns);
  std::vector<int64_t> nb(nbytes, nbytes + nruns);
  const std::string tenant =
      as_tenant.empty() ? TenantOfVarName(name) : as_tenant;
  // Issue-time async pair (kClsAsyncBatch, like GetBatchAsync): its
  // begin→end brackets issue→completion; the inner ReadRuns ScopedOp
  // tags the execution leg as kClsReadRuns under the same span.
  uint64_t tspan = 0;
  int64_t total = 0;
  if (trace::Enabled() || metrics_.enabled())
    for (int64_t i = 0; i < nruns; ++i) total += nbytes[i];
  if (trace::Enabled()) {
    tspan = trace::NewSpan(rank());
    trace::Emit(trace::kOpBegin, tspan, rank(), trace::kClsAsyncBatch,
                -1, total);
  }
  // Issue-time ddmetrics bracket, like GetBatchAsync: issue ->
  // completion latency is THE sample (the inner ReadRuns timer is
  // inert under it — one op, one sample).
  const uint64_t mq0 =
      metrics_.enabled() ? metrics::OpTimer::NowNs() : 0;
  const int mtid = metrics_.enabled() ? metrics_.TenantId(tenant) : 0;
  return SubmitAsync(tenant,
                     [this, name, dst, tenant, tspan, total, mq0, mtid,
                      t = std::move(t), so = std::move(so),
                      dof = std::move(dof), nb = std::move(nb)]() {
    metrics::OpTimer mtimer(&metrics_, trace::kClsAsyncBatch, -1, mtid,
                            static_cast<uint64_t>(total), mq0);
    trace::ScopedSpan sp(tspan);
    int rc = ReadRuns(name, static_cast<char*>(dst), t, so, dof, nb,
                      tenant);
    if (tspan)
      trace::Emit(trace::kOpEnd, tspan, rank(), trace::kClsAsyncBatch,
                  rc, total);
    return rc;
  });
}

int Store::ReadRuns(const std::string& name, char* dst,
                    const std::vector<int64_t>& targets,
                    const std::vector<int64_t>& src_off,
                    const std::vector<int64_t>& dst_off,
                    const std::vector<int64_t>& nbytes,
                    const std::string& as_tenant) {
  // Gateway admission gate: one relaxed load when off. Runs on pool
  // threads (async bodies) too — a deferred async read parks here for
  // at most defer_ms before surfacing kErrAdmission to the waiter.
  if (gateway_.enabled()) {
    const int arc = GatewayAdmit(name, as_tenant);
    if (arc != kOk) return arc;
  }
  GwOpScope gw_scope(gateway_.enabled() ? &gateway_ : nullptr);
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  const int64_t nruns = static_cast<int64_t>(targets.size());
  int64_t total_bytes = 0;
  for (int64_t nb : nbytes) total_bytes += nb;
  // Joins the issue-time span (ReadRunsAsync set it on this pool
  // thread); begin→end here is the execution leg, and a surfaced
  // kErrPeerLost triggers the flight recorder from the dtor.
  trace::ScopedOp top(rank(), trace::kClsReadRuns, -1, total_bytes);
  metrics::OpTimer mtimer(
      &metrics_, trace::kClsReadRuns, -1,
      metrics_.enabled()
          ? metrics_.TenantId(as_tenant.empty() ? TenantOfVarName(name)
                                                : as_tenant)
          : 0,
      static_cast<uint64_t>(total_bytes));
  std::vector<ReadOp> local_ops;
  std::map<int, std::vector<ReadOp>> by_peer;
  // Cache fills never come through here (they ride GetBatchImpl with
  // use_cache=false), so the window fast path always consults: this
  // is exactly where a readahead-warmed window's read becomes an
  // in-RAM gather.
  const bool cache_on = tier_cache_.enabled();
  for (int64_t i = 0; i < nruns; ++i) {
    if (targets[i] < 0 || targets[i] >= world() || nbytes[i] < 0 ||
        dst_off[i] < 0)
      return top.ret(kErrInvalidArg);
    ReadOp op{src_off[i], nbytes[i], dst + dst_off[i]};
    if (cache_on &&
        TierServe(name, v, static_cast<int>(targets[i]), src_off[i],
                  nbytes[i], op.dst))
      continue;
    if (targets[i] == rank()) {
      local_ops.push_back(op);
    } else {
      by_peer[static_cast<int>(targets[i])].push_back(op);
    }
  }
  // Execute exactly like GetBatch's leg: local copies overlap the
  // remote fan-out on the transport pool when both are present.
  constexpr int64_t kOverlapMinLocalBytes = 64 << 10;
  int64_t local_bytes = 0;
  for (const ReadOp& op : local_ops) local_bytes += op.nbytes;
  WorkerPool* pool = by_peer.empty() ? nullptr : transport_->worker_pool();
  int local_rc = kOk;
  std::unique_ptr<TaskGroup> local_group;
  if (!local_ops.empty()) {
    if (pool && local_bytes >= kOverlapMinLocalBytes) {
      local_group.reset(new TaskGroup(pool));
      local_group->Launch([this, &name, &local_ops, &local_rc]() {
        local_rc = ReadLocalV(name, local_ops.data(),
                              static_cast<int64_t>(local_ops.size()));
      });
    } else {
      local_rc = ReadLocalV(name, local_ops.data(),
                            static_cast<int64_t>(local_ops.size()));
      if (local_rc != kOk) return top.ret(local_rc);
    }
  }
  if (!by_peer.empty()) {
    int rc = RemoteRead(name, by_peer, as_tenant);
    if (rc != kOk) {
      if (local_group) local_group->Wait();
      return top.ret(rc);
    }
  }
  if (local_group) local_group->Wait();
  if (local_rc == kOk)
    AccountTenantRead(name, total_bytes, as_tenant);
  return top.ret(local_rc);
}

int Store::AsyncWait(int64_t ticket, int64_t timeout_ms,
                     double* done_mono_s) {
  std::shared_ptr<AsyncState> st;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    auto it = async_.find(ticket);
    if (it == async_.end()) return kErrInvalidArg;
    st = it->second;
  }
  std::unique_lock<std::mutex> lock(st->mu);
  auto ready = [&st] { return st->done; };
  if (timeout_ms < 0) {
    st->cv.wait(lock, ready);
  } else if (!st->cv.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                              ready)) {
    return 0;
  }
  if (done_mono_s) *done_mono_s = st->done_mono_s;
  return st->rc == kOk ? 1 : st->rc;
}

int Store::AsyncRelease(int64_t ticket) {
  std::shared_ptr<AsyncState> st;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    auto it = async_.find(ticket);
    if (it == async_.end()) return kErrInvalidArg;
    st = it->second;
    async_.erase(it);
  }
  std::unique_lock<std::mutex> lock(st->mu);
  st->cv.wait(lock, [&st] { return st->done; });
  return st->rc;
}

int64_t Store::AsyncPending() const {
  std::lock_guard<std::mutex> lock(async_mu_);
  return static_cast<int64_t>(async_.size());
}

int Store::Query(const std::string& name, int64_t* total_rows, int64_t* disp,
                 int64_t* itemsize, int64_t* local_rows) const {
  VarInfo v;
  if (!GetVarInfo(name, &v)) return kErrNotFound;
  if (total_rows) *total_rows = v.total_rows();
  if (disp) *disp = v.disp;
  if (itemsize) *itemsize = v.itemsize;
  if (local_rows) *local_rows = v.nrows;
  return kOk;
}

void Store::NoteCollectiveFailure(int rc) {
  if (rc != kErrPeerLost) return;
  const int lost = transport_->last_failed_peer();
  if (lost < 0 || lost >= world() || lost == rank()) return;
  // Feed the shared suspect registry (idempotent when the verdict came
  // FROM the detector) and the store-level naming channel —
  // dds_fault_stats' last_error_peer prefers the TCP layer's counter,
  // which the TCP barrier abort set itself; this covers the local
  // backend's counting barrier.
  MarkPeerSuspected(lost);
  retry_.last_peer.store(lost);
}

int Store::EpochBegin() {
  int64_t tag;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    if (fence_active_) return kErrEpochState;
    fence_active_ = true;
    tag = ++epoch_tag_;
  }
  int rc = kOk;
  if (epoch_collective_ && world() > 1)
    rc = transport_->Barrier((tag << 1) | 0);
  if (rc != kOk) {
    // Crash-consistent fence: an aborted begin-barrier must leave
    // RECOVERABLE state, not half-state. Roll the state machine back
    // (fence closed, tag un-consumed) — every survivor aborts the same
    // fence, so the rolled-back tags stay aligned across the group and
    // elastic.recover + a re-entered epoch_begin work, instead of
    // every later fence dying on kErrEpochState. The mirror refresh
    // below is skipped too: mirrors keep their last-good pre-fence
    // bytes, exactly the copy failover serves while the owner is down.
    {
      std::unique_lock<std::shared_mutex> lock(mu_);
      fence_active_ = false;
      --epoch_tag_;
    }
    NoteCollectiveFailure(rc);
    return rc;
  }
  // Mirror refresh rides the epoch fence: Update()s applied since the
  // last fence become failover-visible here (the paper's
  // update/epoch_begin contract). Content-version-gated — a static
  // dataset's fence costs one control read per mirror, not a
  // whole-shard pull. Suspected owners are skipped — their mirror
  // keeps the last good bytes — and refresh failures are counted,
  // never fatal (a dying owner must not fail the fence).
  if (replication_ > 1) RefreshMirrors(/*force=*/false);
  return kOk;
}

int Store::EpochEnd() {
  int64_t tag;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    if (!fence_active_) return kErrEpochState;
    fence_active_ = false;
    tag = epoch_tag_;
  }
  if (epoch_collective_ && world() > 1) {
    const int rc = transport_->Barrier((tag << 1) | 1);
    // The fence stays CLOSED on an aborted end-barrier (re-opening it
    // would demand a second epoch_end nobody will issue): the next
    // epoch_begin re-enters cleanly after recovery.
    NoteCollectiveFailure(rc);
    return rc;
  }
  return kOk;
}

void Store::FenceReset() {
  std::unique_lock<std::shared_mutex> lock(mu_);
  fence_active_ = false;
  // epoch_tag_ is deliberately left alone: barrier matching is by the
  // transport's collective seq (realigned by recover via
  // set_barrier_seq), and the tag only labels fences for diagnostics.
}

int Store::Rebind(const std::string& name, void* base) {
  std::unique_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  if (it == vars_.end()) return kErrNotFound;
  VarInfo& v = it->second;
  if (!base && v.shard_bytes() > 0) return kErrInvalidArg;
  // Order matters: clear the CMA mapping BEFORE freeing the old backing
  // (a reader mid-process_vm_readv fails its seqlock recheck and retries
  // over TCP, where this exclusive lock serializes it), publish the new
  // backing only once it is in place.
  transport_->UnpublishVar(name);
  if (v.owned) FreeOwnedShard(name, v.base);
  v.base = static_cast<char*>(base);
  v.owned = false;
  // Cache coherence: the elastic-recovery path rebinds ROLLED-BACK
  // bytes — a warmed copy of the pre-rollback shard must not serve.
  std::vector<std::shared_ptr<tier::Entry>> tier_dropped;
  if (tier_cache_.enabled()) tier_cache_.DropVar(name, &tier_dropped);
  if (integrity_on_.load(std::memory_order_relaxed) && v.base) {
    // Recompute unconditionally: the spill path swaps in identical
    // bytes (same sums), but the elastic-recovery path rebinds a
    // CHECKPOINT-ROLLED-BACK shard — its sums must describe the
    // rolled-back bytes before any mirror re-pull or verified read
    // consults them.
    std::lock_guard<std::mutex> sl(sums_mu_);
    integrity::SumTable st;
    st.sums.resize(static_cast<size_t>(v.nrows));
    const int64_t rb = v.row_bytes();
    for (int64_t r = 0; r < v.nrows; ++r)
      st.sums[static_cast<size_t>(r)] =
          integrity::RowSum(v.base + r * rb, rb, r, sum_seed_);
    auto old = sum_tables_.find(name);
    if (old != sum_tables_.end() && old->second.seq == v.update_seq &&
        old->second.sums != st.sums) {
      // Rebind's contract says "identical contents", but the sums
      // disagree: this is the rollback path. Publish as a NEW content
      // version, so readers' cached tables and the mirror refresh's
      // seq gate all see the change — a same-seq swap of different
      // bytes would read as corruption on every verified read.
      ++v.update_seq;
    }
    st.seq = v.update_seq;
    sum_tables_[name] = std::move(st);
    icnt_.sums_computed.fetch_add(1, std::memory_order_relaxed);
    icnt_.sums_rows.fetch_add(v.nrows, std::memory_order_relaxed);
  }
  transport_->PublishVar(name, v.base, v.shard_bytes());
  lock.unlock();
  ReleaseTierQuota(tier_dropped);
  return kOk;
}

int Store::FreeVar(const std::string& name) {
  int64_t reserved_bytes = -1;
  std::vector<std::shared_ptr<tier::Entry>> tier_dropped;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    auto it = vars_.find(name);
    if (it == vars_.end()) return kErrNotFound;
    reserved_bytes = it->second.quota_reserved;
    transport_->UnpublishVar(name);
    if (it->second.owned) FreeOwnedShard(name, it->second.base);
    vars_.erase(it);
    // Warmed cache entries die with the variable (free is collective;
    // a re-add under the same name restarts at a fresh generation and
    // must never be served the old one's bytes).
    if (tier_cache_.enabled()) tier_cache_.DropVar(name, &tier_dropped);
    // Kept snapshot versions of the variable die with it (their pins
    // now resolve to nothing; UnpinSnapshot tolerates the absence).
    FreeKeepsLocked(name);
    // And so do the PINS themselves: a later add() under the same name
    // restarts at update_seq 0, which would ALIAS a stale pin and
    // serve the new generation's bytes as "pinned". Without the pin a
    // snapshot read degrades to kErrNotFound while freed, then to
    // current bytes after the re-add — the registered-after-the-pin
    // semantics.
    for (auto& kv : snap_pins_) kv.second.pins.erase(name);
    // Drop this rank's mirrors of the freed variable too (free() is
    // collective at the Python layer, so every holder runs this).
    if (replication_ > 1) {
      for (int o = 0; o < world(); ++o) {
        auto mit = vars_.find(MirrorVarName(name, o));
        if (mit == vars_.end()) continue;
        transport_->UnpublishVar(mit->first);
        if (mit->second.owned)
          FreeOwnedShard(mit->first, mit->second.base);
        vars_.erase(mit);
      }
    }
  }
  // Quota returned AFTER the registry lock drops (leaf-lock discipline);
  // exactly what registration reserved, never a post-hoc recomputation.
  ReleaseTierQuota(tier_dropped);
  if (reserved_bytes >= 0)
    TenantRelease(TenantOfVarName(name), reserved_bytes);
  // Integrity tables die with the variable — own table AND every
  // reader-cache entry (free() is collective, and a re-add restarts at
  // update_seq 0: a stale cached table at the same seq would read the
  // new generation's bytes as corruption).
  DropSumsFor(name);
  return kOk;
}

int Store::FreeAll() {
  std::vector<std::pair<std::string, int64_t>> released;
  std::vector<std::shared_ptr<tier::Entry>> tier_dropped;
  {
    std::unique_lock<std::shared_mutex> lock(mu_);
    for (auto& kv : vars_) {
      transport_->UnpublishVar(kv.first);
      if (kv.second.owned) FreeOwnedShard(kv.first, kv.second.base);
      if (kv.second.quota_reserved >= 0)
        released.emplace_back(TenantOfVarName(kv.first),
                              kv.second.quota_reserved);
    }
    vars_.clear();
    snap_pins_.clear();
    kept_versions_ = 0;
    kept_bytes_ = 0;
    // The whole cache dies with the registry, INSIDE the exclusive
    // section (FreeVar's discipline): an entry warmed in the gap
    // between an outside-the-lock evict and the registry clear would
    // survive and serve the dead generation's bytes to a re-added
    // variable of the same name. Quota charges returned after the
    // lock (tenants_mu_ stays a leaf).
    tier_cache_.Evict(-1, &tier_dropped);
  }
  ReleaseTierQuota(tier_dropped);
  for (const auto& r : released) TenantRelease(r.first, r.second);
  {
    std::lock_guard<std::mutex> lock(sums_mu_);
    sum_tables_.clear();
    sum_cache_.clear();
  }
  return kOk;
}

int Store::Barrier(int64_t tag) {
  if (world() <= 1) return kOk;
  const int rc = transport_->Barrier(tag);
  NoteCollectiveFailure(rc);
  return rc;
}

char* Store::LocalBase(const std::string& name) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = vars_.find(name);
  return it == vars_.end() ? nullptr : it->second.base;
}

// `nbytes > sb - offset` with offset <= sb established first, NOT
// `offset + nbytes > sb`: the sum wraps on near-INT64_MAX values from a
// corrupt wire frame and would pass the bound.
static inline bool RangeBad(int64_t offset, int64_t nbytes, int64_t sb) {
  return offset < 0 || nbytes < 0 || offset > sb || nbytes > sb - offset;
}

int Store::ReadLocal(const std::string& name, int64_t offset,
                     int64_t nbytes, void* dst) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = ResolveDataLocked(name);
  if (it == vars_.end()) return kErrNotFound;
  const VarInfo& v = it->second;
  if (RangeBad(offset, nbytes, v.shard_bytes())) return kErrOutOfRange;
  // Cold-tier O_DIRECT path (SetVarFile contract): only after the range
  // check, so error codes are identical to the mmap path; any reader
  // refusal (alignment, ring verdict) falls through to the memcpy.
  if (v.tier == 1 && cold_direct_on_.load(std::memory_order_acquire) &&
      cold_direct_ && cold_direct_->Read(it->first, offset, nbytes, dst))
    return kOk;
  std::memcpy(dst, v.base + offset, nbytes);
  return kOk;
}

int Store::ReadLocalV(const std::string& name, const ReadOp* ops,
                      int64_t n) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = ResolveDataLocked(name);
  if (it == vars_.end()) return kErrNotFound;
  const VarInfo& v = it->second;
  const int64_t sb = v.shard_bytes();
  // Validate every range BEFORE any byte moves so the O_DIRECT batch
  // path and the mmap path surface identical error codes — the mmap
  // loop below then never hits RangeBad and partial-copy-then-error
  // behavior matches the pre-hook tree (it copied ops before the first
  // bad one; an all-good batch is the only case the ring may serve).
  for (int64_t i = 0; i < n; ++i)
    if (RangeBad(ops[i].offset, ops[i].nbytes, sb)) {
      // Preserve the old partial-copy semantics exactly: copy the good
      // prefix, then report the first bad op.
      for (int64_t j = 0; j < i; ++j)
        std::memcpy(ops[j].dst, v.base + ops[j].offset, ops[j].nbytes);
      return kErrOutOfRange;
    }
  if (v.tier == 1 && n > 0 &&
      cold_direct_on_.load(std::memory_order_acquire) && cold_direct_) {
    // ReadBatch is all-or-nothing: one ring submission for the whole
    // run list, or false and the mmap serves everything (no partial
    // application to reason about).
    std::vector<ColdDirectReader::CdOp> batch(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i)
      batch[static_cast<size_t>(i)] = {ops[i].offset, ops[i].nbytes,
                                       ops[i].dst};
    if (cold_direct_->ReadBatch(it->first, batch.data(),
                                static_cast<int>(n)))
      return kOk;
  }
  for (int64_t i = 0; i < n; ++i) {
    const ReadOp& op = ops[i];
    std::memcpy(op.dst, v.base + op.offset, op.nbytes);
  }
  return kOk;
}

int Store::WithShard(const std::string& name,
                     const std::function<int(const char*, int64_t)>& fn)
    const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = ResolveDataLocked(name);
  if (it == vars_.end()) return kErrNotFound;
  return fn(it->second.base, it->second.shard_bytes());
}

bool Store::GetVarInfo(const std::string& name, VarInfo* out) const {
  std::shared_lock<std::shared_mutex> lock(mu_);
  auto it = ResolveMetaLocked(name);
  if (it == vars_.end()) return false;
  *out = it->second;  // copies metadata; base pointer stays valid until free
  return true;
}

// -- ddmetrics: cross-rank pull + SLO monitor ---------------------------------

int64_t Store::MetricsPull(int target, void* out, int64_t cap) {
  if (target < 0 || target >= world() || !out || cap < 0)
    return kErrInvalidArg;
  if (target == rank()) return metrics_.Snapshot(out, cap);
  // Detector short-circuit: a suspected peer costs ZERO control budget
  // and never counts a giveup — a cluster latency view must assemble
  // around a corpse, not stall on it (the caller records the hole).
  if (PeerSuspected(target)) return kErrPeerLost;
  return transport_->ReadMetrics(target, out, cap);
}

int Store::MetricsRecord(int cls, int route, int peer,
                         const std::string& tenant, uint64_t lat_ns,
                         uint64_t bytes) {
  // Loud validation like every sibling entry: a silently dropped
  // sample reads as an empty snapshot with no pointer to the bad
  // argument, and an unchecked peer would wrap in the 24-bit key
  // field and decode as a garbage rank.
  if (cls < 0 || cls >= metrics::kNumClasses || route < 0 ||
      route >= metrics::kNumRoutes || peer < -1 ||
      peer >= (1 << 23))
    return kErrInvalidArg;
  if (!metrics_.enabled()) return kOk;
  metrics_.Record(cls, route, peer, metrics_.TenantId(tenant), lat_ns,
                  bytes);
  return kOk;
}

namespace {
// One SLO objective "p99:5ms" -> (99, 5'000'000 ns). Units ns/us/ms/s;
// the resulting threshold must be >= 1 ns (a zero objective would read
// every op as a breach). False on anything malformed.
bool ParseSloObjective(const std::string& v, int* pct, uint64_t* ns) {
  if (v.size() < 4 || (v[0] != 'p' && v[0] != 'P')) return false;
  char* end = nullptr;
  const long p = std::strtol(v.c_str() + 1, &end, 10);
  if (p <= 0 || p > 100 || !end || *end != ':') return false;
  const char* num = end + 1;
  char* end2 = nullptr;
  const double x = std::strtod(num, &end2);
  if (end2 == num || !(x > 0)) return false;
  const std::string unit(end2);
  double scale = 0;
  if (unit == "ns") scale = 1.0;
  else if (unit == "us") scale = 1e3;
  else if (unit == "ms") scale = 1e6;
  else if (unit == "s") scale = 1e9;
  else return false;
  const double t = x * scale;
  if (!(t >= 1.0) || t > 9e18) return false;
  *pct = static_cast<int>(p);
  *ns = static_cast<uint64_t>(t);
  return true;
}
}  // namespace

int Store::SetTenantSlos(const std::string& spec) {
  std::vector<SloRule> rules;
  bool any_entry = false;
  size_t pos = 0;
  while (pos <= spec.size()) {
    size_t next = spec.find(',', pos);
    if (next == std::string::npos) next = spec.size();
    const std::string entry = spec.substr(pos, next - pos);
    pos = next + 1;
    if (entry.empty()) continue;
    any_entry = true;
    const size_t eq = entry.find('=');
    // A bare "p99:5ms" names the default tenant (like the tier
    // placement spec: "t=" cannot express "").
    const std::string tenant =
        eq == std::string::npos ? "" : entry.substr(0, eq);
    const std::string obj =
        eq == std::string::npos ? entry : entry.substr(eq + 1);
    bool ok = true;
    for (const char c : tenant)
      ok = ok && static_cast<unsigned char>(c) >= 0x20;
    SloRule r;
    ok = ok && ParseSloObjective(obj, &r.pct, &r.threshold_ns);
    if (!ok) continue;  // malformed entries skipped, like every spec
    r.tenant = tenant;
    r.tenant_id = metrics_.TenantId(tenant);
    // An uninternable label (24-slot table full: TenantId folded it
    // into slot 0) must NOT silently monitor the DEFAULT tenant's
    // aggregate in the requested tenant's name — skip the rule, so a
    // spec reduced to nothing surfaces kErrInvalidArg below.
    if (!tenant.empty() && r.tenant_id == 0) continue;
    // Baseline = NOW: the first window judges only traffic after the
    // configure, never the store's whole history.
    metrics_.TenantLatHist(r.tenant_id, r.base_hist, &r.base_count);
    rules.push_back(std::move(r));
  }
  if (any_entry && rules.empty()) return kErrInvalidArg;
  std::lock_guard<std::mutex> lock(slo_mu_);
  slo_rules_ = std::move(rules);
  slo_last_eval_ns_ = 0;
  return kOk;
}

int Store::EvaluateSlos(int64_t* out, int cap_rows) {
  if (!out || cap_rows < 0) return kErrInvalidArg;
  struct Breach {
    int tenant_id;
    int pct;
    uint64_t thr, low, cnt;
  };
  std::vector<Breach> breaches;
  {
    std::lock_guard<std::mutex> lock(slo_mu_);
    if (slo_rules_.empty()) return 0;  // default-off: inert
    const uint64_t now = metrics::OpTimer::NowNs();
    if (slo_window_ms_ > 0 && slo_last_eval_ns_ != 0 &&
        now - slo_last_eval_ns_ <
            static_cast<uint64_t>(slo_window_ms_) * 1000000ull)
      return 0;  // inside the window: keep the running baseline
    slo_last_eval_ns_ = now;
    ++slo_evals_;
    for (SloRule& r : slo_rules_) {
      uint64_t cur[metrics::kBuckets];
      uint64_t cnt = 0;
      metrics_.TenantLatHist(r.tenant_id, cur, &cnt);
      uint64_t n = 0;
      uint64_t delta[metrics::kBuckets];
      for (int b = 0; b < metrics::kBuckets; ++b) {
        // Counters are monotone EXCEPT across a MetricsReset (public
        // API): a post-reset aggregate below the baseline must read
        // as "the window restarted at zero", never as a wrapped
        // ~2^64-count window that fires a garbage breach.
        delta[b] = cur[b] >= r.base_hist[b] ? cur[b] - r.base_hist[b]
                                            : cur[b];
        n += delta[b];
        r.base_hist[b] = cur[b];
      }
      r.base_count = cnt;
      if (n == 0) continue;  // idle tenant: no verdict either way
      // p-quantile bucket: smallest b whose cumulative count reaches
      // ceil(pct/100 * n).
      const uint64_t want = (n * static_cast<uint64_t>(r.pct) + 99) / 100;
      uint64_t cum = 0;
      int qb = metrics::kBuckets - 1;
      for (int b = 0; b < metrics::kBuckets; ++b) {
        cum += delta[b];
        if (cum >= want) {
          qb = b;
          break;
        }
      }
      // Provable breach only: the quantile's WHOLE log2 bucket lies at
      // or above the objective — a bucket straddling the threshold is
      // indeterminate and must not fire (no false breaches from
      // bucketing).
      const uint64_t low = metrics::BucketLow(qb);
      if (low >= r.threshold_ns) {
        breaches.push_back(
            Breach{r.tenant_id, r.pct, r.threshold_ns, low, n});
        ++slo_breaches_;
        slo_last_breach_tenant_ = r.tenant_id;
      }
    }
  }
  // Trace emission AFTER slo_mu_ drops (no emit under a DDS_NO_BLOCKING
  // mutex — the ddtrace discipline).
  int rows = 0;
  for (const Breach& b : breaches) {
    trace::Ev(trace::kSloBreach, rank(), b.tenant_id, b.pct,
              static_cast<int64_t>(b.low));
    // The flight recorder IS the point: the breach postmortem (which
    // ops, which peers, which retries) is in the rings right now.
    trace::Flight(trace::kReasonSloBreach, rank());
    if (rows < cap_rows) {
      int64_t* row = out + static_cast<int64_t>(rows) * 6;
      row[0] = b.tenant_id;
      row[1] = b.pct;
      row[2] = static_cast<int64_t>(b.thr);
      row[3] = static_cast<int64_t>(b.low);
      row[4] = static_cast<int64_t>(b.cnt);
      row[5] = 0;
      ++rows;
    }
  }
  return rows;
}

void Store::SloStats(int64_t out[8]) const {
  for (int i = 0; i < 8; ++i) out[i] = 0;
  std::lock_guard<std::mutex> lock(slo_mu_);
  out[0] = static_cast<int64_t>(slo_rules_.size());
  out[1] = slo_evals_;
  out[2] = slo_breaches_;
  out[3] = slo_window_ms_;
  out[4] = slo_last_breach_tenant_;
}

// -- serving gateway ---------------------------------------------------------

int Store::ConfigureGateway(int enabled, long lease_ms, long defer_ms,
                            int queue_cap, int admit_margin_pct,
                            int lane_share, long pin_ttl_ms) {
  gw::Config c = gateway_.config();
  if (enabled >= 0) c.enabled = enabled ? 1 : 0;
  if (lease_ms >= 0) c.lease_ms = lease_ms > 0 ? lease_ms : 5000;
  if (defer_ms >= 0) c.defer_ms = defer_ms > 0 ? defer_ms : 100;
  if (queue_cap >= 0) c.queue_cap = queue_cap > 0 ? queue_cap : 64;
  if (admit_margin_pct >= 0)
    c.admit_margin_pct = admit_margin_pct > 0 ? admit_margin_pct : 1;
  if (lane_share >= 0) c.lane_share = lane_share;
  gateway_.Configure(c);
  gw_admit_margin_pct_.store(c.admit_margin_pct,
                             std::memory_order_relaxed);
  gw_lane_share_.store(c.lane_share, std::memory_order_relaxed);
  if (pin_ttl_ms >= 0)
    snap_pin_ttl_ms_.store(pin_ttl_ms, std::memory_order_relaxed);
  // Reaper cadence: the lease-renewal heartbeat cadence (~lease/3,
  // HealthMonitor-style) when the gateway is on; half the pin TTL
  // when only stranded-pin reclaim is armed; stopped when neither.
  long reap_ms = 0;
  const long ttl = snap_pin_ttl_ms_.load(std::memory_order_relaxed);
  if (c.enabled)
    reap_ms = c.lease_ms / 3 > 0 ? c.lease_ms / 3 : 1;
  else if (ttl > 0)
    reap_ms = ttl / 2 > 0 ? ttl / 2 : 1;
  ConfigureGwReaper(reap_ms);
  return kOk;
}

int64_t Store::GatewayAttach(const std::string& tenant,
                             int with_snapshot, int64_t quota_bytes) {
  if (!gateway_.enabled()) return kErrInvalidArg;
  if (gateway_.draining()) return kErrAdmission;
  // Reserve BEFORE minting the lease so an over-quota attach fails
  // atomically (nothing to reap).
  bool charged = false;
  if (quota_bytes > 0 &&
      !TenantReserveBytes(tenant, quota_bytes, &charged))
    return kErrQuota;
  int64_t snap_id = 0;
  if (with_snapshot) {
    snap_id = SnapshotAcquire(tenant);
    if (snap_id < 0) {
      if (charged) TenantReleaseBytes(tenant, quota_bytes);
      return snap_id;
    }
  }
  bool first = false;
  const int64_t token = gateway_.Attach(
      rank(), tenant, snap_id, charged ? quota_bytes : 0,
      metrics::OpTimer::NowNs(), &first);
  if (token == 0) {  // drain raced in: roll back like a failed acquire
    if (snap_id > 0) SnapshotRelease(snap_id);
    if (charged) TenantReleaseBytes(tenant, quota_bytes);
    return kErrAdmission;
  }
  // First live session of this tenant arms its lane-budget share:
  // every ephemeral reader of the tenant now rides the same rotated
  // lane slice instead of dialing private pools.
  if (first) {
    const int share = gw_lane_share_.load(std::memory_order_relaxed);
    if (share > 0) transport_->SetTenantLaneBudget(tenant, share);
  }
  trace::Ev(trace::kGwSession, rank(), 0, token, snap_id);
  return token;
}

int Store::GatewayRenew(int64_t token) {
  if (!gateway_.enabled()) return kErrInvalidArg;
  const int rc = gateway_.Renew(token, metrics::OpTimer::NowNs());
  if (rc == kOk) trace::Ev(trace::kGwSession, rank(), 1, token, 0);
  return rc;
}

int Store::GatewayDetach(int64_t token) {
  if (!gateway_.enabled()) return kErrInvalidArg;
  gw::SessionInfo s;
  bool last = false;
  const int rc = gateway_.Detach(token, &s, &last);
  if (rc != kOk) return rc;
  ReleaseGwSession(s, /*expired=*/false);
  if (last && gw_lane_share_.load(std::memory_order_relaxed) > 0)
    transport_->SetTenantLaneBudget(s.tenant, 0);
  return kOk;
}

void Store::ReleaseGwSession(const gw::SessionInfo& s, bool expired) {
  // The lease's whole footprint goes in one pass: snapshot pins (kept
  // copies freed via the existing UnpinSnapshot path, peers
  // best-effort), then the quota reservation. Deferred-queue slots
  // die with the waiting call; lane shares are cleared by the caller
  // on last-of-tenant.
  if (s.snap_id > 0) SnapshotRelease(s.snap_id);
  if (s.quota_bytes > 0) TenantReleaseBytes(s.tenant, s.quota_bytes);
  trace::Ev(trace::kGwSession, rank(), expired ? 3 : 2, s.token,
            s.snap_id);
}

int64_t Store::GatewayAttachTo(int target, const std::string& tenant,
                               int with_snapshot, int64_t quota_bytes) {
  if (target < 0 || target == rank())
    return GatewayAttach(tenant, with_snapshot, quota_bytes);
  if (target >= world()) return kErrInvalidArg;
  int64_t token = 0;
  const int rc = transport_->GatewayControl(
      target, 0, tenant, with_snapshot ? 1 : 0, quota_bytes, &token);
  return rc == kOk ? token : rc;
}

int Store::GatewayRenewTo(int target, int64_t token) {
  if (target < 0 || target == rank()) return GatewayRenew(token);
  if (target >= world()) return kErrInvalidArg;
  return transport_->GatewayControl(target, 1, "", token, 0, nullptr);
}

int Store::GatewayDetachTo(int target, int64_t token) {
  if (target < 0 || target == rank()) return GatewayDetach(token);
  if (target >= world()) return kErrInvalidArg;
  return transport_->GatewayControl(target, 2, "", token, 0, nullptr);
}

int Store::GatewayDrain(long deadline_ms) {
  if (!gateway_.enabled()) return kOk;
  return gateway_.Drain(deadline_ms, &gw_stop_);
}

int Store::GatewayReap() {
  const uint64_t now = metrics::OpTimer::NowNs();
  if (gateway_.enabled()) {
    std::vector<gw::SessionInfo> dead;
    std::vector<std::string> cleared;
    gateway_.ExpireLeases(now, &dead, &cleared);
    for (const gw::SessionInfo& s : dead)
      ReleaseGwSession(s, /*expired=*/true);
    if (gw_lane_share_.load(std::memory_order_relaxed) > 0)
      for (const std::string& t : cleared)
        transport_->SetTenantLaneBudget(t, 0);
  }
  // Stale-pin reclaim (works gateway-off): TTL-expired pins and pins
  // minted by a suspected-dead owner rank (snap ids carry their
  // minting rank in the top 32 bits). Pins held by a LIVE gateway
  // lease are exempt — the lease is their liveness.
  const long ttl_ms = snap_pin_ttl_ms_.load(std::memory_order_relaxed);
  std::vector<int64_t> stale;
  {
    std::shared_lock<std::shared_mutex> lock(mu_);
    for (const auto& kv : snap_pins_) {
      if (gateway_.HoldsSnapshot(kv.first)) continue;
      const int owner = static_cast<int>(kv.first >> 32);
      const bool dead_owner = owner != rank() && owner >= 0 &&
                              owner < world() && PeerSuspected(owner);
      const bool ttl_hit =
          ttl_ms > 0 && kv.second.created_ns != 0 &&
          now > kv.second.created_ns &&
          now - kv.second.created_ns >
              static_cast<uint64_t>(ttl_ms) * 1000000ull;
      if (dead_owner || ttl_hit) stale.push_back(kv.first);
    }
  }
  int reclaimed = 0;
  for (int64_t id : stale)
    if (UnpinSnapshot(id) == kOk) ++reclaimed;
  if (reclaimed > 0) {
    snap_reclaimed_.fetch_add(reclaimed, std::memory_order_relaxed);
    trace::Ev(trace::kGwSession, rank(), 4, reclaimed, 0);
  }
  return reclaimed;
}

void Store::GatewayStats(int64_t out[gw::kGwStatSlots]) const {
  gateway_.Stats(out);
}

int Store::GatewayAdmit(const std::string& name,
                        const std::string& as_tenant) {
  const std::string tenant =
      as_tenant.empty() ? TenantOfVarName(name) : as_tenant;
  // Protected = the tenant has an SLO rule: admission exists to keep
  // THESE tenants inside their objectives, so they always flow.
  bool is_protected = false;
  {
    std::lock_guard<std::mutex> lock(slo_mu_);
    for (const SloRule& r : slo_rules_)
      if (r.tenant == tenant) {
        is_protected = true;
        break;
      }
  }
  long retry_after = 0;
  const int rc = gateway_.Admit(
      is_protected, [this] { return GatewayPressure(); }, &gw_stop_,
      &retry_after);
  if (rc != kOk) {
    trace::Ev(trace::kGwShed, rank(), 1, retry_after,
              gateway_.draining() ? 1 : 0);
    // Shed storm: one flight dump per 64 rejects (the first included)
    // — the "who was shed and why" postmortem without flooding the
    // flight buffer during a sustained storm.
    if (gw_sheds_since_flight_.fetch_add(1, std::memory_order_relaxed) %
            64 ==
        0)
      trace::Flight(trace::kReasonShedStorm, rank());
  }
  return rc;
}

bool Store::GatewayPressure() {
  // Queue-depth model input: the async admission gate's deferred
  // backlog. Read BEFORE slo_mu_ — both stay leaf mutexes.
  uint64_t qdepth = 0;
  {
    std::lock_guard<std::mutex> lock(async_mu_);
    qdepth = static_cast<uint64_t>(async_deferred_.size());
  }
  const int margin =
      gw_admit_margin_pct_.load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(slo_mu_);
  for (const SloRule& r : slo_rules_) {
    uint64_t cur[metrics::kBuckets];
    uint64_t cnt = 0;
    metrics_.TenantLatHist(r.tenant_id, cur, &cnt);
    uint64_t n = 0;
    uint64_t delta[metrics::kBuckets];
    for (int b = 0; b < metrics::kBuckets; ++b) {
      delta[b] = cur[b] >= r.base_hist[b] ? cur[b] - r.base_hist[b]
                                          : cur[b];
      n += delta[b];
    }
    if (n == 0) continue;  // idle protected tenant: no pressure signal
    const uint64_t want =
        (n * static_cast<uint64_t>(r.pct) + 99) / 100;
    uint64_t cum = 0;
    int qb = metrics::kBuckets - 1;
    for (int b = 0; b < metrics::kBuckets; ++b) {
      cum += delta[b];
      if (cum >= want) {
        qb = b;
        break;
      }
    }
    // Predicted p99: the live window quantile's CONSERVATIVE upper
    // bucket edge (EvaluateSlos uses the lower edge — it must prove a
    // breach; this gate must prevent one), scaled by the queued
    // backlog (each deferred read adds roughly one service time to
    // whatever lands behind it). Baselines are NOT advanced:
    // EvaluateSlos owns the window; this is a read-only view of the
    // same delta. Float math — thresholds are user input and an
    // integer product can overflow.
    const long double predicted =
        static_cast<long double>(metrics::BucketHigh(qb)) *
        (1.0L + static_cast<long double>(qdepth));
    const long double limit =
        static_cast<long double>(r.threshold_ns) * margin / 100.0L;
    if (predicted >= limit) return true;
  }
  return false;
}

void Store::ConfigureGwReaper(long interval_ms) {
  // Whole stop+start transition is one critical section (the scrub
  // discipline: two racing configures must never assign over a
  // joinable std::thread).
  std::lock_guard<std::mutex> cfg(gw_cfg_mu_);
  StopGwReaperLocked();
  if (interval_ms <= 0) return;
  std::lock_guard<std::mutex> lock(gw_mu_);
  gw_stop_.store(false, std::memory_order_relaxed);
  gw_reap_ms_.store(interval_ms, std::memory_order_relaxed);
  gw_thread_ = std::thread([this] { GwReaperLoop(); });
}

void Store::StopGwReaper() {
  std::lock_guard<std::mutex> cfg(gw_cfg_mu_);
  StopGwReaperLocked();
}

void Store::StopGwReaperLocked() {
  gw_stop_.store(true, std::memory_order_relaxed);
  // Join OUTSIDE gw_mu_ (gw_cfg_mu_ stays held — that is the point).
  std::thread t;
  {
    std::lock_guard<std::mutex> lock(gw_mu_);
    t = std::move(gw_thread_);
  }
  if (t.joinable()) t.join();
}

void Store::GwReaperLoop() {
  while (!gw_stop_.load(std::memory_order_relaxed)) {
    FaultSleepMs(gw_reap_ms_.load(std::memory_order_relaxed),
                 &gw_stop_);
    if (gw_stop_.load(std::memory_order_relaxed)) return;
    GatewayReap();
  }
}

}  // namespace dds
