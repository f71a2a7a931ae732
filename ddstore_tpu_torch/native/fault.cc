#include "fault.h"

#include <chrono>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "store.h"
#include "trace.h"

namespace dds {

namespace {

// splitmix64: the decision function must be a pure, well-mixed function
// of (seed, draw index) — counters then depend only on the seed and the
// NUMBER of draws, never on thread interleaving.
uint64_t Mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Salt folded into the control domain's hash so the two domains'
// schedules decorrelate even at equal counter values.
constexpr uint64_t kCtrlDomainSalt = 0xC7B1A9E5D3F08642ULL;

bool ParseKind(const std::string& tok, FaultKind* kind, int* dflt_ms) {
  if (tok == "reset") {
    *kind = FaultKind::kReset;
    *dflt_ms = 0;
  } else if (tok == "trunc") {
    *kind = FaultKind::kTrunc;
    *dflt_ms = 0;
  } else if (tok == "delay") {
    *kind = FaultKind::kDelay;
    *dflt_ms = 10;
  } else if (tok == "stall") {
    *kind = FaultKind::kStall;
    *dflt_ms = 2000;
  } else if (tok == "corrupt") {
    *kind = FaultKind::kCorrupt;
    *dflt_ms = 8;  // bytes to flip per injected event
  } else if (tok == "conndrop") {
    *kind = FaultKind::kConnDrop;
    *dflt_ms = 0;
  } else {
    return false;
  }
  return true;
}

}  // namespace

FaultInjector& FaultInjector::Get() {
  static FaultInjector* inst = new FaultInjector();
  return *inst;
}

FaultInjector::FaultInjector() {
  const char* spec = std::getenv("DDSTORE_FAULT_SPEC");
  if (!spec || !*spec) return;
  uint64_t seed = 0;
  if (const char* s = std::getenv("DDSTORE_FAULT_SEED"))
    seed = std::strtoull(s, nullptr, 10);
  const char* ranks = std::getenv("DDSTORE_FAULT_RANKS");
  Configure(spec, seed, ranks ? ranks : "");
}

int FaultInjector::Configure(const std::string& spec, uint64_t seed,
                             const std::string& ranks_csv) {
  std::vector<Rule> rules;
  std::vector<Rule> ctrl_rules;
  // Independent cumulative-probability spaces: a spec may dedicate up
  // to probability 1.0 to EACH domain (the control plane sees far
  // fewer ops, so chaos runs arm it at much higher rates).
  double cum_p = 0.0, ctrl_cum_p = 0.0;
  size_t pos = 0;
  while (pos < spec.size()) {
    size_t end = spec.find(',', pos);
    if (end == std::string::npos) end = spec.size();
    std::string entry = spec.substr(pos, end - pos);
    pos = end + 1;
    if (entry.empty()) continue;
    // [ctrl-]kind:probability[:param_ms]
    size_t c1 = entry.find(':');
    if (c1 == std::string::npos) return kErrInvalidArg;
    std::string kind_tok = entry.substr(0, c1);
    bool ctrl = false;
    if (kind_tok.compare(0, 5, "ctrl-") == 0) {
      ctrl = true;
      kind_tok = kind_tok.substr(5);
    }
    FaultKind kind;
    int param_ms;
    if (!ParseKind(kind_tok, &kind, &param_ms)) return kErrInvalidArg;
    // The control plane has no payload to truncate or corrupt: its
    // failure modes are a dropped connection and latency.
    if (ctrl &&
        (kind == FaultKind::kTrunc || kind == FaultKind::kCorrupt))
      return kErrInvalidArg;
    // conndrop is the mirror restriction: it hard-closes a SESSION
    // control connection, which the data plane does not have — only
    // "ctrl-conndrop:p" is a valid arm.
    if (!ctrl && kind == FaultKind::kConnDrop) return kErrInvalidArg;
    size_t c2 = entry.find(':', c1 + 1);
    char* endp = nullptr;
    const std::string pstr =
        entry.substr(c1 + 1, c2 == std::string::npos ? std::string::npos
                                                     : c2 - c1 - 1);
    double p = std::strtod(pstr.c_str(), &endp);
    if (!endp || *endp || p < 0.0 || p > 1.0) return kErrInvalidArg;
    if (c2 != std::string::npos) {
      long ms = std::strtol(entry.c_str() + c2 + 1, &endp, 10);
      if (!endp || *endp || ms < 0) return kErrInvalidArg;
      param_ms = static_cast<int>(ms);
    }
    double& cp = ctrl ? ctrl_cum_p : cum_p;
    cp += p;
    if (cp > 1.0 + 1e-9) return kErrInvalidArg;
    // Threshold in 2^64 space; clamp the running sum to the top.
    double scaled = cp * 1.8446744073709552e19;  // 2^64
    uint64_t cum = scaled >= 1.8446744073709552e19
                       ? ~0ULL
                       : static_cast<uint64_t>(scaled);
    (ctrl ? ctrl_rules : rules).push_back(Rule{kind, cum, param_ms});
  }
  std::vector<int> ranks;
  size_t rp = 0;
  while (rp < ranks_csv.size()) {
    size_t end = ranks_csv.find(',', rp);
    if (end == std::string::npos) end = ranks_csv.size();
    if (end > rp)
      ranks.push_back(
          static_cast<int>(std::strtol(ranks_csv.substr(rp, end - rp).c_str(),
                                       nullptr, 10)));
    rp = end + 1;
  }
  {
    std::lock_guard<std::mutex> lock(mu_);
    rules_ = std::move(rules);
    ctrl_rules_ = std::move(ctrl_rules);
    ranks_ = std::move(ranks);
    seed_ = seed;
    n_.store(0);
    ctrl_n_.store(0);
    c_checks_.store(0);
    c_reset_.store(0);
    c_trunc_.store(0);
    c_delay_.store(0);
    c_stall_.store(0);
    c_delay_ms_.store(0);
    c_corrupt_.store(0);
    c_ctrl_checks_.store(0);
    c_ctrl_injected_.store(0);
    enabled_.store(!rules_.empty() || !ctrl_rules_.empty(),
                   std::memory_order_release);
  }
  return kOk;
}

FaultDecision FaultInjector::Draw(int rank) {
  if (!enabled()) return {};
  std::lock_guard<std::mutex> lock(mu_);
  if (rules_.empty()) return {};
  if (!ranks_.empty()) {
    bool match = false;
    for (int r : ranks_) match = match || r == rank;
    // Filtered ranks do NOT consume a draw: the schedule seen by the
    // targeted rank is a function of ITS op sequence alone.
    if (!match) return {};
  }
  const uint64_t n = n_.fetch_add(1, std::memory_order_relaxed);
  c_checks_.fetch_add(1, std::memory_order_relaxed);
  const uint64_t h = Mix64(seed_ ^ Mix64(n));
  for (const Rule& r : rules_) {
    if (h < r.cum) {
      switch (r.kind) {
        case FaultKind::kReset:
          c_reset_.fetch_add(1, std::memory_order_relaxed);
          break;
        case FaultKind::kTrunc:
          c_trunc_.fetch_add(1, std::memory_order_relaxed);
          break;
        case FaultKind::kDelay:
          c_delay_.fetch_add(1, std::memory_order_relaxed);
          c_delay_ms_.fetch_add(r.param_ms, std::memory_order_relaxed);
          break;
        case FaultKind::kStall:
          c_stall_.fetch_add(1, std::memory_order_relaxed);
          c_delay_ms_.fetch_add(r.param_ms, std::memory_order_relaxed);
          break;
        case FaultKind::kCorrupt:
          c_corrupt_.fetch_add(1, std::memory_order_relaxed);
          break;
        case FaultKind::kConnDrop:  // ctrl-only by Configure; unreachable
        case FaultKind::kNone:
          break;
      }
      // A second Mix64 pass decorrelates the corruption positions from
      // the rule-selection comparison (both pure functions of the draw).
      return FaultDecision{r.kind, r.param_ms, Mix64(h)};
    }
  }
  return {};
}

FaultDecision FaultInjector::DrawCtrl(int rank) {
  if (!enabled()) return {};
  std::lock_guard<std::mutex> lock(mu_);
  // No ctrl-* arm configured: zero cost, zero draws — the data-only
  // schedules are untouched by construction.
  if (ctrl_rules_.empty()) return {};
  if (!ranks_.empty()) {
    bool match = false;
    for (int r : ranks_) match = match || r == rank;
    if (!match) return {};
  }
  const uint64_t n = ctrl_n_.fetch_add(1, std::memory_order_relaxed);
  c_ctrl_checks_.fetch_add(1, std::memory_order_relaxed);
  const uint64_t h = Mix64(seed_ ^ kCtrlDomainSalt ^ Mix64(n));
  for (const Rule& r : ctrl_rules_) {
    if (h < r.cum) {
      // ctrl_injected is the ONLY counter this domain touches: the
      // data-plane stats (delay_ms included) stay bit-identical with
      // the ctrl arm present or absent — the determinism pin.
      c_ctrl_injected_.fetch_add(1, std::memory_order_relaxed);
      return FaultDecision{r.kind, r.param_ms, Mix64(h)};
    }
  }
  return {};
}

FaultInjector::Stats FaultInjector::stats() const {
  Stats s;
  s.checks = c_checks_.load();
  s.reset = c_reset_.load();
  s.trunc = c_trunc_.load();
  s.delay = c_delay_.load();
  s.stall = c_stall_.load();
  s.delay_ms = c_delay_ms_.load();
  s.corrupt = c_corrupt_.load();
  s.ctrl_checks = c_ctrl_checks_.load();
  s.ctrl_injected = c_ctrl_injected_.load();
  return s;
}

long ControlTimeoutMsFromEnv() {
  long ms = 1000;
  if (const char* env = std::getenv("DDSTORE_CONTROL_TIMEOUT_MS")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) ms = v;
  }
  return ms;
}

int ControlRetryMaxFromEnv() {
  int n = 2;
  if (const char* env = std::getenv("DDSTORE_CONTROL_RETRY_MAX")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v >= 0) n = static_cast<int>(v);
  }
  return n;
}

long ControlBackoffMs(int attempt) {
  long ms = 25L << (attempt < 4 ? attempt : 4);
  return ms > 200 ? 200 : ms;
}

RetryPolicy RetryPolicy::FromEnv() {
  // Deadline default: keep in sync with binding.py
  // DEFAULT_OP_DEADLINE_S (the readahead shared-budget math reads it
  // Python-side).
  RetryPolicy p{3, 50, 300.0};
  if (const char* env = std::getenv("DDSTORE_RETRY_MAX")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v >= 0) p.max_retries = static_cast<int>(v);
  }
  if (const char* env = std::getenv("DDSTORE_RETRY_BASE_MS")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v >= 0) p.base_ms = v;
  }
  if (const char* env = std::getenv("DDSTORE_OP_DEADLINE_S")) {
    char* end = nullptr;
    double v = std::strtod(env, &end);
    if (end != env && v > 0) p.deadline_s = v;
  }
  return p;
}

long BackoffMs(const RetryPolicy& pol, int attempt, uint64_t salt) {
  if (pol.base_ms <= 0) return 0;
  long ms = pol.base_ms << (attempt < 16 ? attempt : 16);
  if (ms > 2000 || ms <= 0) ms = 2000;
  // +- 25% deterministic jitter: decorrelates concurrent leaves without
  // making two identical runs' SLEEP sequences differ.
  const uint64_t h = Mix64(salt * 0x9e3779b97f4a7c15ULL + attempt);
  const long span = ms / 2;
  if (span > 0) ms = ms - span / 2 + static_cast<long>(h % span);
  return ms;
}

int RetryTransientLoop(RetryStats& stats, int target,
                       const std::atomic<bool>* stop, uint64_t salt,
                       const std::function<int()>& attempt,
                       const std::function<void()>& on_retry,
                       double deadline_override,
                       const std::function<bool()>& suspect) {
  // Detector short-circuit BEFORE the first attempt: a peer the
  // heartbeat already declared dead gets no dial/read at all (no
  // giveup counted — the budget was never engaged).
  if (suspect && suspect()) return kErrPeerLost;
  int rc = attempt();
  if (rc == kOk) return rc;
  if (rc != kErrTransport) {
    // Server-reported data error: the bytes do not exist; retrying
    // cannot make them.
    stats.fatal.fetch_add(1, std::memory_order_relaxed);
    if (target >= 0) stats.last_peer.store(target);
    return rc;
  }
  RetryPolicy pol = RetryPolicy::FromEnv();
  // The degraded-pipeline budget share (see the header): a refetch
  // sharing its window's deadline must not be handed a fresh full one.
  if (deadline_override > 0.0) pol.deadline_s = deadline_override;
  const auto deadline =
      std::chrono::steady_clock::now() +
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::duration<double>(pol.deadline_s));
  int att = 0;
  for (;;) {
    stats.transient.fetch_add(1, std::memory_order_relaxed);
    if (target >= 0) stats.last_peer.store(target);
    // Teardown is not a verdict about the peer: abort with the plain
    // transient code, no giveup counted.
    if (stop && stop->load(std::memory_order_relaxed)) return kErrTransport;
    // Detector verdict mid-ladder: stop burning the budget — the
    // failover layer reroutes now. Not a giveup (the detector, not the
    // deadline, classified the peer).
    if (suspect && suspect()) return kErrPeerLost;
    if (att >= pol.max_retries ||
        std::chrono::steady_clock::now() >= deadline) {
      // Budget exhausted: reclassify as the bounded "owner is gone"
      // signal. No NEW attempt starts after the deadline; worst case is
      // deadline + one attempt's own connect/read timeouts.
      stats.giveups.fetch_add(1, std::memory_order_relaxed);
      return kErrPeerLost;
    }
    const long ms = BackoffMs(pol, att, salt);
    if (ms > 0) {
      // Backoff is recorded BEFORE the sleep so a trace cut mid-ladder
      // still shows the sleep that was about to happen.
      trace::Ev(trace::kBackoff, -1, target, ms, att);
      FaultSleepMs(ms, stop);
      stats.backoff_ms.fetch_add(ms, std::memory_order_relaxed);
    }
    stats.retries.fetch_add(1, std::memory_order_relaxed);
    trace::Ev(trace::kRetry, -1, target, att, rc);
    ++att;
    if (on_retry) on_retry();
    rc = attempt();
    if (rc == kOk) return rc;
    if (rc != kErrTransport) {
      stats.fatal.fetch_add(1, std::memory_order_relaxed);
      if (target >= 0) stats.last_peer.store(target);
      return rc;
    }
  }
}

void FaultSleepMs(long ms, const std::atomic<bool>* stop) {
  using clock = std::chrono::steady_clock;
  const auto until = clock::now() + std::chrono::milliseconds(ms);
  while (clock::now() < until) {
    if (stop && stop->load(std::memory_order_relaxed)) return;
    const auto left = until - clock::now();
    const auto slice = std::chrono::milliseconds(50);
    std::this_thread::sleep_for(left < slice ? left : slice);
  }
}

}  // namespace dds
