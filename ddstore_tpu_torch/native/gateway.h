// Serving gateway: session multiplexing, histogram-driven admission
// control, lease-reaped sessions, graceful drain.
//
// DDStore's premise is every-rank-reads-any-row, but production traffic
// is thousands of SHORT-LIVED readers (inference workers, eval sweeps,
// dataloader pools) that cannot each hold a persistent lane pool per
// peer — and nothing stops a burst of them from driving a protected
// tenant through its p99 SLO before the after-the-fact replan fires.
// This module is the robustness half of that story:
//
// * SESSIONS — an ephemeral reader attaches with a tenant label and
//   gets a token; its reads ride the rank's EXISTING lane pools via
//   the per-tenant lane-budget rotation (1000 readers ≈ a handful of
//   lanes). Remote attach rides the dedicated control connection as
//   kOpAttach/kOpDetach/kOpLease — no new sockets, no new framing.
// * ADMISSION — a gate in front of Get/GetBatch/ReadRuns consults the
//   live ddmetrics tenant histograms: when a protected tenant's
//   predicted p99 (live window quantile scaled by the async admission
//   gate's queue depth) approaches its SLO, requests from OVER-SHARE
//   tenants are deferred (bounded queue, deadline-aware) and then
//   rejected with non-fatal kErrAdmission carrying a retry-after
//   hint. Protected tenants keep flowing; the SLO is defended BEFORE
//   the breach instead of replanned after it.
// * LEASES — every session is a heartbeat-renewed lease. Expiry
//   atomically releases the session's snapshot pins, quota
//   reservation, deferred-queue slot, and lane-budget share — a
//   SIGKILLed reader can no longer strand kept versions forever.
// * DRAIN — Drain() stops admitting, lets in-flight ops finish under
//   a deadline, then sheds with kErrAdmission; elastic recovery
//   drains a leaving rank instead of RSTing its readers.
//
// The gateway holds NO references into Store: the Store wires pin /
// quota / lane-budget release in its reaper, and passes the admission
// pressure predicate as a callback — this class is pure session +
// admission state, testable standalone.
//
// Off state (DDSTORE_GATEWAY=0, the default): no thread, no lock, ONE
// relaxed atomic load per read op. Byte-, error-code- and seeded-
// fault-counter-identical to the pre-gateway tree (pinned by test).

#ifndef DDSTORE_TPU_GATEWAY_H_
#define DDSTORE_TPU_GATEWAY_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include "thread_annotations.h"

namespace dds {
namespace gw {

// Runtime configuration. Environment defaults are resolved by the
// Store (DDSTORE_GATEWAY, DDSTORE_GW_*); tests reconfigure at runtime
// through dds_gateway_configure.
struct Config {
  int enabled = 0;
  long lease_ms = 5000;      // session lease; renew at ~lease/3
  long defer_ms = 100;       // max time an over-share request queues
  int queue_cap = 64;        // bounded deferred-queue slots
  int admit_margin_pct = 80; // pressure when predicted p99 >= margin% of SLO
  int lane_share = 0;        // per-tenant lane budget while sessions exist
};

// What a lease held; returned on detach/expiry so the owner (Store)
// can release the pinned snapshot / quota / lane share.
struct SessionInfo {
  int64_t token = 0;
  std::string tenant;
  int64_t snap_id = 0;      // 0 = no snapshot pinned by this session
  int64_t quota_bytes = 0;  // 0 = no quota reservation charged
};

// Stats layout (keep in sync with binding.py GATEWAY_STAT_KEYS):
// [enabled, sessions, attaches, detaches, expired, renewals,
//  admitted, deferred, rejected, drain_sheds, draining, inflight,
//  deferred_now, last_retry_after_ms, 0, 0].
// attaches..rejected and drain_sheds are monotone; the rest gauges.
constexpr int kGwStatSlots = 16;

class Gateway {
 public:
  Gateway() = default;
  Gateway(const Gateway&) = delete;
  Gateway& operator=(const Gateway&) = delete;

  // THE hot-path gate: one relaxed load. Every other member is
  // reached only when this returns true.
  bool enabled() const {
    return enabled_.load(std::memory_order_relaxed) != 0;
  }
  bool draining() const {
    return draining_.load(std::memory_order_relaxed);
  }

  // Apply a new configuration. Enabling clears a previous drain (an
  // elastic-recovered rank re-opens for business explicitly).
  void Configure(const Config& c);
  Config config() const;

  // -- sessions (lease table) ------------------------------------------------

  // Mint a session. `first_of_tenant` reports whether this is the
  // tenant's first live session (the caller arms the lane-budget
  // share exactly once per tenant). Fails with 0 while draining.
  int64_t Attach(int rank, const std::string& tenant, int64_t snap_id,
                 int64_t quota_bytes, uint64_t now_ns,
                 bool* first_of_tenant);
  // Heartbeat: push the lease deadline out. kErrNotFound after expiry
  // (the reader learns its session died and re-attaches).
  int Renew(int64_t token, uint64_t now_ns);
  // Graceful goodbye. `out` receives what the lease held;
  // `last_of_tenant` reports whether the tenant has no sessions left
  // (the caller clears the lane-budget share).
  int Detach(int64_t token, SessionInfo* out, bool* last_of_tenant);
  // Reap every lease whose deadline passed. Expired sessions land in
  // `out`; tenants whose LAST session expired land in `last_tenants`.
  void ExpireLeases(uint64_t now_ns, std::vector<SessionInfo>* out,
                    std::vector<std::string>* last_tenants);
  // True when any live session pinned `snap_id` (lease-held pins are
  // exempt from the stale-pin TTL reap — the lease IS their liveness).
  bool HoldsSnapshot(int64_t snap_id) const;
  int64_t SessionCount() const;

  // -- admission -------------------------------------------------------------

  // Admission verdict for one read. Protected tenants (those with an
  // SLO rule) always pass. Over-share tenants pass while `pressure`
  // is false; under pressure they occupy a bounded deferred-queue
  // slot for up to defer_ms (re-evaluating `pressure` as in-flight
  // ops complete), then give up with kErrAdmission. `retry_after_ms`
  // carries the hint clients feed into seeded-jitter backoff.
  // `stop` aborts the wait (store teardown).
  int Admit(bool is_protected, const std::function<bool()>& pressure,
            const std::atomic<bool>* stop, long* retry_after_ms);
  // In-flight accounting around the op body (Drain waits on it; OpEnd
  // wakes deferred waiters so they re-check pressure immediately).
  void OpBegin();
  void OpEnd();

  // -- drain -----------------------------------------------------------------

  // Stop admitting (new + deferred requests shed with kErrAdmission),
  // wait up to deadline_ms for in-flight ops to finish. Returns kOk
  // when the gateway went quiet, kErrTransport when ops remained at
  // the deadline. Idempotent; the draining flag stays set until a
  // Configure() with enabled >= 1 re-opens.
  int Drain(long deadline_ms, const std::atomic<bool>* stop);

  void Stats(int64_t out[kGwStatSlots]) const;

 private:
  struct Session {
    std::string tenant;
    int64_t snap_id = 0;
    int64_t quota_bytes = 0;
    uint64_t deadline_ns = 0;
  };

  long RetryAfterMsLocked() const DDS_REQUIRES(admit_mu_);

  std::atomic<int> enabled_{0};
  std::atomic<bool> draining_{false};

  // Hot-path config (read per admission decision without cfg_mu_).
  std::atomic<long> defer_ms_{100};
  std::atomic<int> queue_cap_{64};

  // Cold config, read back by config()/the Store reaper.
  mutable std::mutex cfg_mu_;
  Config cfg_ DDS_GUARDED_BY(cfg_mu_);

  // Lease table. Serve-loop handlers (kOpAttach/kOpDetach/kOpLease)
  // hold it while a remote reader waits on the control round-trip:
  // nothing slower than a map operation may ever run under it.
  mutable std::mutex lease_mu_ DDS_NO_BLOCKING;
  std::map<int64_t, Session> sessions_ DDS_GUARDED_BY(lease_mu_);
  std::map<std::string, int> tenant_sessions_ DDS_GUARDED_BY(lease_mu_);
  int64_t token_counter_ DDS_GUARDED_BY(lease_mu_) = 0;
  int64_t attaches_ DDS_GUARDED_BY(lease_mu_) = 0;
  int64_t detaches_ DDS_GUARDED_BY(lease_mu_) = 0;
  int64_t expired_ DDS_GUARDED_BY(lease_mu_) = 0;
  int64_t renewals_ DDS_GUARDED_BY(lease_mu_) = 0;

  // Admission / deferred-queue state. Blocking BY DESIGN: deferred
  // requests cv-wait under it (bounded by defer_ms), so it is never
  // taken from the serve loop or under lease_mu_.
  mutable std::mutex admit_mu_;
  std::condition_variable admit_cv_;
  int64_t inflight_ DDS_GUARDED_BY(admit_mu_) = 0;
  int64_t waiting_ DDS_GUARDED_BY(admit_mu_) = 0;
  int64_t admitted_ DDS_GUARDED_BY(admit_mu_) = 0;
  int64_t deferred_ DDS_GUARDED_BY(admit_mu_) = 0;
  int64_t rejected_ DDS_GUARDED_BY(admit_mu_) = 0;
  int64_t drain_sheds_ DDS_GUARDED_BY(admit_mu_) = 0;
  long last_retry_after_ms_ DDS_GUARDED_BY(admit_mu_) = 0;
};

}  // namespace gw
}  // namespace dds

#endif  // DDSTORE_TPU_GATEWAY_H_
