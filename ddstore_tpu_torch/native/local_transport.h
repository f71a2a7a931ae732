// In-process transport: multiple Store instances in one process (one per
// "rank", e.g. one per thread in tests) form a named group and read each
// other's shards with plain memcpy. This is the deterministic fake backend
// the reference lacks (its only backends are MPI RMA and libfabric,
// reference include/ddstore.hpp:54) — it lets unit tests cover index
// math, bounds, epochs, and batching without any network or multi-process
// launch.

#ifndef DDSTORE_TPU_LOCAL_TRANSPORT_H_
#define DDSTORE_TPU_LOCAL_TRANSPORT_H_

#include <atomic>
#include <condition_variable>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "fault.h"
#include "store.h"
#include "thread_annotations.h"

namespace dds {

// Shared state of one in-process group, keyed by group id.
class LocalGroup {
 public:
  static std::shared_ptr<LocalGroup> GetOrCreate(const std::string& gid,
                                                 int world);
  // Drop the group from the global registry (members keep their shared_ptr).
  static void Release(const std::string& gid);

  explicit LocalGroup(int world)
      : world_(world), members_(world, nullptr),
        ever_registered_(world, false) {}

  int world() const { return world_; }
  void Register(int rank, Store* store);
  void Unregister(int rank);
  Store* member(int rank);
  // Non-blocking liveness peek for the heartbeat detector: true while
  // `rank` is registered OR has never registered yet (bootstrap is not
  // death); false only after an Unregister — the in-process analogue
  // of a closed listener.
  bool AliveOrPending(int rank);

  // Counting barrier, per tag; every member must arrive with the same
  // tag. FAILURE-AWARE: the wait aborts promptly with
  // kErrPeerLost when a member that has NOT yet arrived is dead —
  // store closed mid-wait (the in-process kill vehicle, the
  // AliveOrPending semantics Ping already uses) or declared dead by
  // the caller's `suspect` oracle (the HealthMonitor view, same truth
  // the TCP barrier consults); `*lost_rank` names it. A member that
  // died AFTER arriving already contributed its information —
  // completion wins, even posthumously (the benign staggered-teardown
  // case). Arrivals are tracked PER RANK: an aborting caller withdraws
  // its own arrival AND any dead member's, so a re-entry at the same
  // tag (the rolled-back epoch fence) can neither double-count a live
  // rank nor be satisfied by a corpse's stale arrival. A full 120 s
  // wait with no death stays kErrTransport.
  int Barrier(int64_t tag, int rank, int* lost_rank = nullptr,
              const std::function<bool(int)>& suspect = {});

 private:
  struct BarrierState {
    std::set<int> arrived;
    int left = 0;
  };
  const int world_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<Store*> members_ DDS_GUARDED_BY(mu_);
  std::vector<bool> ever_registered_ DDS_GUARDED_BY(mu_);
  std::map<int64_t, BarrierState> barriers_ DDS_GUARDED_BY(mu_);
};

class LocalTransport : public Transport {
 public:
  LocalTransport(std::shared_ptr<LocalGroup> group, int rank)
      : group_(std::move(group)), rank_(rank),
        // Control-plane retry budget, resolved once (control ops may
        // be called under the peer registry path; no getenv per call).
        ctrl_retry_max_(ControlRetryMaxFromEnv()) {}
  ~LocalTransport() override;

  // Called once the owning Store exists (Store takes the transport in its
  // constructor, so registration happens just after).
  void Attach(Store* store);

  int Read(int target, const std::string& name, int64_t offset,
           int64_t nbytes, void* dst) override;
  int ReadV(int target, const std::string& name, const ReadOp* ops,
            int64_t n) override;
  // In-process liveness: a peer whose store was torn down (Unregister)
  // is dead; one that has not constructed yet is pending, not dead. No
  // fault-injector draw — control plane stays off the data path's
  // deterministic schedule.
  bool Ping(int target, long timeout_ms) override {
    (void)timeout_ms;
    return group_->AliveOrPending(target);
  }
  // Control-plane content-version probe (mirror refresh gate): direct
  // registry read of the peer store, no fault-injector draw.
  int64_t ReadVarSeq(int target, const std::string& name) override;
  // Integrity sum fetch: direct call into the peer store's owner-side
  // table (control plane, no fault-injector draw).
  int ReadRowSums(int target, const std::string& name, int64_t row0,
                  int64_t count, int64_t* seq, uint64_t* sums) override;
  // Snapshot-epoch pin/release: direct call into the peer store's
  // owner-side half (control plane, no DATA-plane fault-injector
  // draw; the separate ctrl arm injects here and is absorbed by the
  // bounded control-retry loop, like the TCP side).
  int GatewayControl(int target, int verb, const std::string& tenant,
                     int64_t arg, int64_t arg2,
                     int64_t* token_out) override;
  int SnapshotControl(int target, int64_t snap_id, bool pin,
                      const std::string& tenant) override;
  // ddmetrics histogram pull: direct serialization out of the peer
  // store's registry (control plane, ctrl-arm injector draws absorbed
  // by the bounded retry like the other control ops).
  int64_t ReadMetrics(int target, void* out, int64_t cap) override;
  // Failure-aware counting barrier: aborts kErrPeerLost when a member
  // store closed mid-wait or the store's suspect oracle declares one
  // dead; the lost rank is recorded for last_failed_peer().
  int Barrier(int64_t tag) override;
  // The store's suspect view, consulted by the barrier wait (the
  // in-process analogue of the TCP barrier's detector poll).
  void SetSuspectOracle(std::function<bool(int)> oracle) override {
    std::lock_guard<std::mutex> lock(oracle_mu_);
    suspect_oracle_ = std::move(oracle);
  }
  // The member a barrier abort named (-1 = none). The Store's
  // collective-failure handler forwards this into its retry stats so
  // the Python layer's classify names the dead peer uniformly across
  // backends.
  int last_failed_peer() const override {
    return last_lost_peer_.load(std::memory_order_relaxed);
  }
  int rank() const override { return rank_; }
  int world() const override { return group_->world(); }

 private:
  // One ctrl-domain injector draw for a control op served by `target`
  // (drawn as the TARGET rank, like the data-path DrawLocalFault):
  // kErrTransport for reset/stall (the caller's bounded control retry
  // absorbs it), in-line sleep for delay, kOk otherwise.
  int DrawCtrlFault(int target);

  std::shared_ptr<LocalGroup> group_;
  const int rank_;
  const int ctrl_retry_max_;
  std::mutex oracle_mu_ DDS_NO_BLOCKING;
  std::function<bool(int)> suspect_oracle_ DDS_GUARDED_BY(oracle_mu_);
  std::atomic<int> last_lost_peer_{-1};
};

}  // namespace dds

#endif  // DDSTORE_TPU_LOCAL_TRANSPORT_H_
