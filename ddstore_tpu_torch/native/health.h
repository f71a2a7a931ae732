// Heartbeat failure detector: a per-store control-plane liveness view.
//
// The data path learns a peer is dead only by burning a transient-retry
// ladder (up to DDSTORE_OP_DEADLINE_S) against it. This monitor learns it
// in O(heartbeat interval): a background thread pings every peer over a
// dedicated control-plane channel (Transport::Ping — its frames never
// touch the data path's fault injector, so seeded chaos schedules stay
// bit-identical with the detector on or off), and DDSTORE_HEARTBEAT_SUSPECT_N
// consecutive failures publish the peer as SUSPECTED. The replicated-read
// failover layer (store.cc RemoteRead) consults the view to short-circuit
// suspected peers straight onto their replicas — no per-read deadline
// burn — and the data path feeds its own ladder verdicts back in
// (MarkSuspected) so the two detection paths share one truth.
//
// The suspicion state doubles as the store's suspect registry even when
// the ping thread is not running (Init allocates it; MarkSuspected /
// ResetPeer work either way): with the heartbeat off, suspicion comes
// only from data-path give-ups and clears only on UpdatePeer (elastic
// replacement).

#ifndef DDSTORE_TPU_HEALTH_H_
#define DDSTORE_TPU_HEALTH_H_

#include <atomic>
#include <cstdint>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>

#include "thread_annotations.h"

namespace dds {

class HealthMonitor {
 public:
  HealthMonitor() = default;
  ~HealthMonitor();

  HealthMonitor(const HealthMonitor&) = delete;
  HealthMonitor& operator=(const HealthMonitor&) = delete;

  // Allocate the per-peer state (idempotent). Must run before any
  // Suspected/MarkSuspected query; separate from Start so the suspect
  // registry exists even with the heartbeat disabled.
  void Init(int rank, int world);

  // Start (or restart) the ping thread: every `interval_ms` each peer is
  // pinged once with `pinger`; `suspect_n` consecutive failures mark it
  // suspected, one success clears it. interval_ms <= 0 stops the thread
  // (the suspect registry keeps its state).
  void Start(long interval_ms, int suspect_n,
             std::function<bool(int)> pinger);
  void Stop();
  bool running() const { return running_.load(std::memory_order_relaxed); }
  long interval_ms() const { return interval_ms_; }
  int suspect_n() const { return suspect_n_; }

  bool Suspected(int target) const;
  // Data-path verdict feed-in: a transient-retry budget exhausted against
  // `target` is as strong a death signal as a missed-ping streak — and
  // STICKIER: a peer whose listener still answers pings while its data
  // path fails (blackholed port, injected 100% resets) must not be
  // re-trusted every interval, or each fresh read burns a whole ladder
  // again. A ladder verdict therefore needs `suspect_n` CONSECUTIVE
  // ping successes to clear (bounds the opposite error too: a live
  // peer wrongly retired by the failover's naming fallback is restored
  // in ~suspect_n intervals). Heartbeat-raised suspicion still clears
  // on the first success.
  void MarkSuspected(int target);
  // Elastic recovery re-pointed `target` at a replacement process: clean
  // slate (streak + suspicion).
  void ResetPeer(int target);

  // Writes min(world, cap) entries of 0/1 suspicion flags; returns the
  // count written.
  int SuspectFlags(int64_t* out, int cap) const;
  int SuspectedCount() const;

  // [pings_sent, ping_failures, suspects_raised, running]
  void Counters(int64_t out[4]) const;

 private:
  void Loop();

  // Guards start/stop + config. The loop thread reads its config
  // (interval_ms_/suspect_n_/pinger_) unlocked: written only in Start,
  // which joins any previous thread first — happens-before by thread
  // creation, not by lock.
  mutable std::mutex mu_;
  std::thread thread_ DDS_GUARDED_BY(mu_);
  std::atomic<bool> stop_{false};
  std::atomic<bool> running_{false};
  int rank_ = 0;
  int world_ = 0;
  long interval_ms_ = 0;
  int suspect_n_ = 3;
  std::function<bool(int)> pinger_;
  // Sized `world_` by Init; lock-free reads on the failover hot path.
  std::unique_ptr<std::atomic<int>[]> fails_;
  std::unique_ptr<std::atomic<bool>[]> suspected_;
  // Remaining consecutive ping successes a data-path verdict demands
  // before its suspicion clears (0 = heartbeat-owned suspicion).
  std::unique_ptr<std::atomic<int>[]> verdict_hold_;
  std::atomic<int64_t> pings_{0}, failures_{0}, raised_{0};
};

// Heartbeat knobs. DDSTORE_HEARTBEAT_MS: ping interval; unset defaults to
// 250 ms WHEN replication > 1 (the failover layer needs the view) and 0
// (off) otherwise — the R=1 default must add zero threads and zero
// behavior change. DDSTORE_HEARTBEAT_SUSPECT_N: consecutive failures
// before suspicion (default 3).
long HeartbeatIntervalMsFromEnv(int replication);
int HeartbeatSuspectNFromEnv();

}  // namespace dds

#endif  // DDSTORE_TPU_HEALTH_H_
