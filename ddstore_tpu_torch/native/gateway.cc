#include "gateway.h"

#include <chrono>

#include "store.h"  // error codes

namespace dds {
namespace gw {

void Gateway::Configure(const Config& c) {
  {
    std::lock_guard<std::mutex> lock(cfg_mu_);
    cfg_ = c;
  }
  defer_ms_.store(c.defer_ms > 0 ? c.defer_ms : 1,
                  std::memory_order_relaxed);
  queue_cap_.store(c.queue_cap > 0 ? c.queue_cap : 1,
                   std::memory_order_relaxed);
  if (c.enabled) draining_.store(false, std::memory_order_relaxed);
  enabled_.store(c.enabled ? 1 : 0, std::memory_order_relaxed);
  // Deferred waiters re-check enabled/draining on wakeup.
  admit_cv_.notify_all();
}

Config Gateway::config() const {
  std::lock_guard<std::mutex> lock(cfg_mu_);
  return cfg_;
}

int64_t Gateway::Attach(int rank, const std::string& tenant,
                        int64_t snap_id, int64_t quota_bytes,
                        uint64_t now_ns, bool* first_of_tenant) {
  if (first_of_tenant) *first_of_tenant = false;
  if (draining_.load(std::memory_order_relaxed)) return 0;
  long lease_ms;
  {
    std::lock_guard<std::mutex> lock(cfg_mu_);
    lease_ms = cfg_.lease_ms;
  }
  std::lock_guard<std::mutex> lock(lease_mu_);
  const int64_t token =
      (static_cast<int64_t>(rank) << 32) | ++token_counter_;
  Session s;
  s.tenant = tenant;
  s.snap_id = snap_id;
  s.quota_bytes = quota_bytes;
  s.deadline_ns = now_ns + static_cast<uint64_t>(lease_ms) * 1000000ull;
  sessions_[token] = std::move(s);
  if (++tenant_sessions_[tenant] == 1 && first_of_tenant)
    *first_of_tenant = true;
  ++attaches_;
  return token;
}

int Gateway::Renew(int64_t token, uint64_t now_ns) {
  long lease_ms;
  {
    std::lock_guard<std::mutex> lock(cfg_mu_);
    lease_ms = cfg_.lease_ms;
  }
  std::lock_guard<std::mutex> lock(lease_mu_);
  auto it = sessions_.find(token);
  if (it == sessions_.end()) return kErrNotFound;
  it->second.deadline_ns =
      now_ns + static_cast<uint64_t>(lease_ms) * 1000000ull;
  ++renewals_;
  return kOk;
}

int Gateway::Detach(int64_t token, SessionInfo* out,
                    bool* last_of_tenant) {
  if (last_of_tenant) *last_of_tenant = false;
  std::lock_guard<std::mutex> lock(lease_mu_);
  auto it = sessions_.find(token);
  if (it == sessions_.end()) return kErrNotFound;
  if (out) {
    out->token = token;
    out->tenant = it->second.tenant;
    out->snap_id = it->second.snap_id;
    out->quota_bytes = it->second.quota_bytes;
  }
  auto tit = tenant_sessions_.find(it->second.tenant);
  if (tit != tenant_sessions_.end() && --tit->second <= 0) {
    tenant_sessions_.erase(tit);
    if (last_of_tenant) *last_of_tenant = true;
  }
  sessions_.erase(it);
  ++detaches_;
  admit_cv_.notify_all();  // a freed lease slot may clear pressure
  return kOk;
}

void Gateway::ExpireLeases(uint64_t now_ns, std::vector<SessionInfo>* out,
                           std::vector<std::string>* last_tenants) {
  std::lock_guard<std::mutex> lock(lease_mu_);
  for (auto it = sessions_.begin(); it != sessions_.end();) {
    if (it->second.deadline_ns > now_ns) {
      ++it;
      continue;
    }
    if (out) {
      SessionInfo si;
      si.token = it->first;
      si.tenant = it->second.tenant;
      si.snap_id = it->second.snap_id;
      si.quota_bytes = it->second.quota_bytes;
      out->push_back(std::move(si));
    }
    auto tit = tenant_sessions_.find(it->second.tenant);
    if (tit != tenant_sessions_.end() && --tit->second <= 0) {
      if (last_tenants) last_tenants->push_back(tit->first);
      tenant_sessions_.erase(tit);
    }
    it = sessions_.erase(it);
    ++expired_;
  }
}

bool Gateway::HoldsSnapshot(int64_t snap_id) const {
  if (snap_id == 0) return false;
  std::lock_guard<std::mutex> lock(lease_mu_);
  for (const auto& kv : sessions_)
    if (kv.second.snap_id == snap_id) return true;
  return false;
}

int64_t Gateway::SessionCount() const {
  std::lock_guard<std::mutex> lock(lease_mu_);
  return static_cast<int64_t>(sessions_.size());
}

long Gateway::RetryAfterMsLocked() const {
  // Deeper backlog ⇒ longer hint: one defer window per queued slot
  // ahead of the caller, clamped so clients never park for minutes.
  const long defer = defer_ms_.load(std::memory_order_relaxed);
  long hint = defer * (1 + waiting_);
  if (hint > 60000) hint = 60000;
  if (hint < defer) hint = defer;
  return hint;
}

int Gateway::Admit(bool is_protected,
                   const std::function<bool()>& pressure,
                   const std::atomic<bool>* stop, long* retry_after_ms) {
  if (retry_after_ms) *retry_after_ms = 0;
  if (draining_.load(std::memory_order_relaxed)) {
    std::lock_guard<std::mutex> lock(admit_mu_);
    ++rejected_;
    ++drain_sheds_;
    last_retry_after_ms_ = RetryAfterMsLocked();
    if (retry_after_ms) *retry_after_ms = last_retry_after_ms_;
    return kErrAdmission;
  }
  if (is_protected || !pressure || !pressure()) {
    std::lock_guard<std::mutex> lock(admit_mu_);
    ++admitted_;
    return kOk;
  }
  // Over-share tenant under pressure: defer in a bounded queue,
  // re-checking as completions/detaches signal, then reject.
  const long defer = defer_ms_.load(std::memory_order_relaxed);
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(defer);
  std::unique_lock<std::mutex> lk(admit_mu_);
  if (waiting_ >= queue_cap_.load(std::memory_order_relaxed)) {
    ++rejected_;
    last_retry_after_ms_ = RetryAfterMsLocked();
    if (retry_after_ms) *retry_after_ms = last_retry_after_ms_;
    return kErrAdmission;
  }
  ++waiting_;
  ++deferred_;
  for (;;) {
    if (draining_.load(std::memory_order_relaxed) ||
        (stop && stop->load(std::memory_order_relaxed)))
      break;
    // `pressure` reads store metrics (its own leaf locks) — legal
    // under admit_mu_ (nothing takes admit_mu_ under store locks),
    // and holding it keeps the slot accounting consistent.
    if (!pressure()) {
      --waiting_;
      ++admitted_;
      admit_cv_.notify_all();
      return kOk;
    }
    const auto now = std::chrono::steady_clock::now();
    if (now >= deadline) break;
    // Slice the wait so pressure decay (histogram windows move even
    // without completions) is noticed without a wakeup.
    auto slice = deadline - now;
    if (slice > std::chrono::milliseconds(5))
      slice = std::chrono::milliseconds(5);
    admit_cv_.wait_for(lk, slice);
  }
  --waiting_;
  ++rejected_;
  if (draining_.load(std::memory_order_relaxed)) ++drain_sheds_;
  last_retry_after_ms_ = RetryAfterMsLocked();
  if (retry_after_ms) *retry_after_ms = last_retry_after_ms_;
  admit_cv_.notify_all();
  return kErrAdmission;
}

void Gateway::OpBegin() {
  std::lock_guard<std::mutex> lock(admit_mu_);
  ++inflight_;
}

void Gateway::OpEnd() {
  std::lock_guard<std::mutex> lock(admit_mu_);
  if (inflight_ > 0) --inflight_;
  // Completions are the admission gate's wakeup edge: a deferred
  // request re-checks pressure as soon as load drains.
  admit_cv_.notify_all();
}

int Gateway::Drain(long deadline_ms, const std::atomic<bool>* stop) {
  draining_.store(true, std::memory_order_relaxed);
  const auto deadline = std::chrono::steady_clock::now() +
                        std::chrono::milliseconds(
                            deadline_ms > 0 ? deadline_ms : 0);
  std::unique_lock<std::mutex> lk(admit_mu_);
  admit_cv_.notify_all();  // deferred waiters shed immediately
  while (inflight_ > 0) {
    if (stop && stop->load(std::memory_order_relaxed)) break;
    const auto now = std::chrono::steady_clock::now();
    if (now >= deadline) break;
    auto slice = deadline - now;
    if (slice > std::chrono::milliseconds(10))
      slice = std::chrono::milliseconds(10);
    admit_cv_.wait_for(lk, slice);
  }
  return inflight_ == 0 ? kOk : kErrTransport;
}

void Gateway::Stats(int64_t out[kGwStatSlots]) const {
  for (int i = 0; i < kGwStatSlots; ++i) out[i] = 0;
  out[0] = enabled_.load(std::memory_order_relaxed);
  out[10] = draining_.load(std::memory_order_relaxed) ? 1 : 0;
  {
    std::lock_guard<std::mutex> lock(lease_mu_);
    out[1] = static_cast<int64_t>(sessions_.size());
    out[2] = attaches_;
    out[3] = detaches_;
    out[4] = expired_;
    out[5] = renewals_;
  }
  {
    std::lock_guard<std::mutex> lock(admit_mu_);
    out[6] = admitted_;
    out[7] = deferred_;
    out[8] = rejected_;
    out[9] = drain_sheds_;
    out[11] = inflight_;
    out[12] = waiting_;
    out[13] = last_retry_after_ms_;
  }
}

}  // namespace gw
}  // namespace dds
