#include "health.h"

#include <chrono>
#include <cstdlib>

#include "fault.h"
#include "trace.h"

namespace dds {

HealthMonitor::~HealthMonitor() { Stop(); }

void HealthMonitor::Init(int rank, int world) {
  std::lock_guard<std::mutex> lock(mu_);
  if (fails_) return;
  rank_ = rank;
  world_ = world > 0 ? world : 0;
  if (world_ > 0) {
    fails_.reset(new std::atomic<int>[world_]);
    suspected_.reset(new std::atomic<bool>[world_]);
    verdict_hold_.reset(new std::atomic<int>[world_]);
    for (int i = 0; i < world_; ++i) {
      fails_[i].store(0, std::memory_order_relaxed);
      suspected_[i].store(false, std::memory_order_relaxed);
      verdict_hold_[i].store(0, std::memory_order_relaxed);
    }
  }
}

void HealthMonitor::Start(long interval_ms, int suspect_n,
                          std::function<bool(int)> pinger) {
  Stop();
  std::lock_guard<std::mutex> lock(mu_);
  if (interval_ms <= 0 || world_ <= 1 || !pinger) return;
  interval_ms_ = interval_ms;
  suspect_n_ = suspect_n > 0 ? suspect_n : 1;
  pinger_ = std::move(pinger);
  stop_.store(false, std::memory_order_relaxed);
  running_.store(true, std::memory_order_relaxed);
  thread_ = std::thread([this] { Loop(); });
}

void HealthMonitor::Stop() {
  std::thread t;
  {
    std::lock_guard<std::mutex> lock(mu_);
    stop_.store(true, std::memory_order_relaxed);
    if (thread_.joinable()) t = std::move(thread_);
  }
  if (t.joinable()) t.join();
  running_.store(false, std::memory_order_relaxed);
}

void HealthMonitor::Loop() {
  while (!stop_.load(std::memory_order_relaxed)) {
    for (int t = 0; t < world_; ++t) {
      if (t == rank_) continue;
      if (stop_.load(std::memory_order_relaxed)) break;
      const bool ok = pinger_(t);
      pings_.fetch_add(1, std::memory_order_relaxed);
      if (ok) {
        fails_[t].store(0, std::memory_order_relaxed);
        // Heartbeat-raised suspicion clears on the first success (a
        // restarted/healed peer is not dead) — but a DATA-PATH ladder
        // verdict is stickier: the data port can be dead while the
        // listener still answers pings, and re-trusting such a peer
        // every interval would burn a fresh ladder per read. The
        // verdict needs suspect_n consecutive successes to clear
        // (which also restores a live peer the failover's naming
        // fallback retired by mistake, in ~suspect_n intervals).
        int hold = verdict_hold_[t].load(std::memory_order_relaxed);
        if (hold > 0)
          hold = verdict_hold_[t].fetch_sub(
                     1, std::memory_order_relaxed) - 1;
        if (hold <= 0 &&
            suspected_[t].exchange(false, std::memory_order_relaxed))
          trace::Ev(trace::kSuspectClear, rank_, t, 0, 0);
      } else {
        failures_.fetch_add(1, std::memory_order_relaxed);
        // A failure re-arms any draining verdict hold.
        if (verdict_hold_[t].load(std::memory_order_relaxed) > 0)
          verdict_hold_[t].store(suspect_n_, std::memory_order_relaxed);
        const int n = fails_[t].fetch_add(1, std::memory_order_relaxed) + 1;
        if (n >= suspect_n_ &&
            !suspected_[t].exchange(true, std::memory_order_relaxed)) {
          raised_.fetch_add(1, std::memory_order_relaxed);
          // Verdict moment: record it and snapshot every thread's last
          // events — the flight recorder's "who was doing what when
          // the peer died" story (0 = heartbeat-raised).
          trace::Ev(trace::kSuspect, rank_, t, 0, 0);
          trace::Flight(trace::kReasonSuspect, rank_);
        }
      }
    }
    // Interruptible sleep (<= 50 ms slices): teardown must not wait out
    // an interval.
    FaultSleepMs(interval_ms_, &stop_);
  }
  running_.store(false, std::memory_order_relaxed);
}

bool HealthMonitor::Suspected(int target) const {
  if (!suspected_ || target < 0 || target >= world_) return false;
  return suspected_[target].load(std::memory_order_relaxed);
}

void HealthMonitor::MarkSuspected(int target) {
  if (!suspected_ || target < 0 || target >= world_) return;
  verdict_hold_[target].store(suspect_n_ > 0 ? suspect_n_ : 1,
                              std::memory_order_relaxed);
  if (!suspected_[target].exchange(true, std::memory_order_relaxed)) {
    raised_.fetch_add(1, std::memory_order_relaxed);
    // Data-path ladder verdict (1 = ladder-raised), with a flight
    // snapshot: with replication in force kErrPeerLost never SURFACES
    // (the read fails over) — this transition is the postmortem
    // moment, and it runs under the failing read's span.
    trace::Ev(trace::kSuspect, rank_, target, 1, 0);
    trace::Flight(trace::kReasonSuspect, rank_);
  }
}

void HealthMonitor::ResetPeer(int target) {
  if (!suspected_ || target < 0 || target >= world_) return;
  fails_[target].store(0, std::memory_order_relaxed);
  verdict_hold_[target].store(0, std::memory_order_relaxed);
  if (suspected_[target].exchange(false, std::memory_order_relaxed))
    trace::Ev(trace::kSuspectClear, rank_, target, 0, 0);
}

int HealthMonitor::SuspectFlags(int64_t* out, int cap) const {
  if (!out || cap <= 0 || !suspected_) return 0;
  const int n = world_ < cap ? world_ : cap;
  for (int i = 0; i < n; ++i)
    out[i] = suspected_[i].load(std::memory_order_relaxed) ? 1 : 0;
  return n;
}

int HealthMonitor::SuspectedCount() const {
  if (!suspected_) return 0;
  int n = 0;
  for (int i = 0; i < world_; ++i)
    if (suspected_[i].load(std::memory_order_relaxed)) ++n;
  return n;
}

void HealthMonitor::Counters(int64_t out[4]) const {
  out[0] = pings_.load(std::memory_order_relaxed);
  out[1] = failures_.load(std::memory_order_relaxed);
  out[2] = raised_.load(std::memory_order_relaxed);
  out[3] = running() ? 1 : 0;
}

long HeartbeatIntervalMsFromEnv(int replication) {
  if (const char* env = std::getenv("DDSTORE_HEARTBEAT_MS")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v >= 0) return v;
  }
  return replication > 1 ? 250 : 0;
}

int HeartbeatSuspectNFromEnv() {
  if (const char* env = std::getenv("DDSTORE_HEARTBEAT_SUSPECT_N")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) return static_cast<int>(v);
  }
  return 3;
}

}  // namespace dds
