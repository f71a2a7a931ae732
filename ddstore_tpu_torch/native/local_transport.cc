#include "local_transport.h"

#include <chrono>
#include <cstring>

#include "trace.h"

namespace dds {

namespace {
std::mutex g_groups_mu;
std::map<std::string, std::shared_ptr<LocalGroup>>* g_groups = nullptr;
}  // namespace

std::shared_ptr<LocalGroup> LocalGroup::GetOrCreate(const std::string& gid,
                                                    int world) {
  std::lock_guard<std::mutex> lock(g_groups_mu);
  if (!g_groups) g_groups = new std::map<std::string, std::shared_ptr<LocalGroup>>();
  auto it = g_groups->find(gid);
  if (it != g_groups->end()) {
    if (it->second->world() != world) return nullptr;
    return it->second;
  }
  auto g = std::make_shared<LocalGroup>(world);
  (*g_groups)[gid] = g;
  return g;
}

void LocalGroup::Release(const std::string& gid) {
  std::lock_guard<std::mutex> lock(g_groups_mu);
  if (g_groups) g_groups->erase(gid);
}

void LocalGroup::Register(int rank, Store* store) {
  std::lock_guard<std::mutex> lock(mu_);
  if (rank >= 0 && rank < world_) {
    members_[rank] = store;
    ever_registered_[rank] = true;
  }
  cv_.notify_all();
}

bool LocalGroup::AliveOrPending(int rank) {
  std::lock_guard<std::mutex> lock(mu_);
  if (rank < 0 || rank >= world_) return false;
  return members_[rank] != nullptr || !ever_registered_[rank];
}

void LocalGroup::Unregister(int rank) {
  std::lock_guard<std::mutex> lock(mu_);
  if (rank >= 0 && rank < world_) members_[rank] = nullptr;
  // A member death is a barrier wake-up event: waiters must notice the
  // closed store NOW, not after sleeping out their 120 s timeout.
  cv_.notify_all();
}

Store* LocalGroup::member(int rank) {
  std::unique_lock<std::mutex> lock(mu_);
  if (rank < 0 || rank >= world_) return nullptr;
  // A peer may not have constructed its store yet (threads race at
  // startup); wait briefly for registration — but ONLY for bootstrap.
  // A member that registered and then closed is dead NOW: a 30 s
  // grace for a corpse would serialize every control op and retry
  // ladder behind it.
  cv_.wait_for(lock, std::chrono::seconds(30),
               [&] { return members_[rank] != nullptr ||
                            ever_registered_[rank]; });
  return members_[rank];
}

int LocalGroup::Barrier(int64_t tag, int rank, int* lost_rank,
                        const std::function<bool(int)>& suspect) {
  std::unique_lock<std::mutex> lock(mu_);
  BarrierState& b = barriers_[tag];
  b.arrived.insert(rank);
  cv_.notify_all();
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(120);
  int lost = -1;
  bool done = false;
  for (;;) {
    auto it = barriers_.find(tag);
    // Completion wins over abort: once everyone has arrived, the
    // barrier's information is complete and the collective succeeds —
    // including a member that arrived and THEN died or was suspected
    // (its contribution was delivered; the benign staggered-teardown
    // case must not read as a dead fence).
    if (it != barriers_.end() &&
        static_cast<int>(it->second.arrived.size()) >= world_) {
      done = true;
      break;
    }
    // Death poll, NOT-YET-ARRIVED members only: one whose store closed
    // mid-wait (registered then unregistered — bootstrap is not death)
    // can never arrive, and neither can one the caller's detector
    // declared dead.
    const std::set<int>& arr = barriers_[tag].arrived;
    for (int r = 0; r < world_ && lost < 0; ++r) {
      if (arr.count(r)) continue;
      if (ever_registered_[r] && members_[r] == nullptr) lost = r;
      if (lost < 0 && suspect && suspect(r)) lost = r;
    }
    if (lost >= 0) break;
    const auto now = std::chrono::steady_clock::now();
    if (now >= deadline) break;
    const auto slice = std::chrono::milliseconds(50);
    const auto left = deadline - now;
    cv_.wait_for(lock, left < slice ? left : slice);
  }
  if (!done) {
    // Withdraw our arrival — and every DEAD member's: a rolled-back
    // fence re-enters at the SAME tag, and neither a stale live count
    // nor a corpse's arrival from the aborted attempt may satisfy the
    // re-entered barrier (the corpse cannot participate again; its
    // replacement arrives fresh after recovery).
    BarrierState& bw = barriers_[tag];
    bw.arrived.erase(rank);
    for (int r = 0; r < world_; ++r)
      if (ever_registered_[r] && members_[r] == nullptr)
        bw.arrived.erase(r);
    if (bw.left >= static_cast<int>(bw.arrived.size()))
      barriers_.erase(tag);
    if (lost >= 0) {
      if (lost_rank) *lost_rank = lost;
      return kErrPeerLost;
    }
    return kErrTransport;
  }
  // Erase when every CURRENT arrival has left (left == arrived == world
  // in the clean case; with withdrawals, the last leaver of a
  // divergent barrier — some members completed, others aborted — still
  // reclaims the entry instead of leaking it).
  BarrierState& b2 = barriers_[tag];
  ++b2.left;
  if (b2.left >= static_cast<int>(b2.arrived.size()))
    barriers_.erase(tag);
  return kOk;
}

void LocalTransport::Attach(Store* store) { group_->Register(rank_, store); }

LocalTransport::~LocalTransport() { group_->Unregister(rank_); }

int LocalTransport::Barrier(int64_t tag) {
  std::function<bool(int)> oracle;
  {
    std::lock_guard<std::mutex> lock(oracle_mu_);
    oracle = suspect_oracle_;
  }
  std::function<bool(int)> suspect;
  if (oracle)
    // Never self-suspect: our own rank answering its own barrier is
    // definitionally alive.
    suspect = [o = std::move(oracle), me = rank_](int r) {
      return r != me && o(r);
    };
  int lost = -1;
  const int rc = group_->Barrier(tag, rank_, &lost, suspect);
  if (rc == kErrPeerLost) {
    last_lost_peer_.store(lost, std::memory_order_relaxed);
    trace::Ev(trace::kBarrierAbort, rank_, tag, -1, lost);
    trace::Flight(trace::kReasonBarrierAbort, rank_);
  }
  return rc;
}

int LocalTransport::DrawCtrlFault(int target) {
  FaultInjector& fi = FaultInjector::Get();
  if (!fi.enabled()) return kOk;
  const FaultDecision d = fi.DrawCtrl(target);
  switch (d.kind) {
    case FaultKind::kReset:
    case FaultKind::kStall:
    case FaultKind::kConnDrop:
      // No wire to reset (or hard-close) here: all degrade to "this
      // control op transiently failed" — the caller's bounded control
      // retry absorbs it (stall fails WITHOUT sleeping, matching the
      // local data-path convention: there is no client timeout to
      // trip).
      return kErrTransport;
    case FaultKind::kDelay:
      FaultSleepMs(d.param_ms, nullptr);
      return kOk;
    default:
      return kOk;
  }
}

namespace {
// Fault injection for the in-process backend (DDSTORE_FAULT_SPEC): there
// is no wire to reset here, so reset/trunc/stall all degrade to "this
// read transiently failed" (kErrTransport — absorbed by the Store's
// retry layer, since this transport has no internal retry; stall fails
// WITHOUT sleeping — there is no client timeout to trip on the local
// path, and an uninterruptible 2 s sleep would only serialize the
// consumer); delay serves late; corrupt is returned to the CALLER,
// which performs the read and then flips the landed bytes — the local
// analogue of a mangled wire payload (no error fires; only checksum
// verification can notice). One draw per transport call, same
// determinism contract as the TCP serve loop.
int DrawLocalFault(int rank, FaultDecision* corrupt) {
  FaultInjector& fi = FaultInjector::Get();
  if (!fi.enabled()) return kOk;
  const FaultDecision d = fi.Draw(rank);
  switch (d.kind) {
    case FaultKind::kReset:
    case FaultKind::kTrunc:
    case FaultKind::kStall:
      return kErrTransport;
    case FaultKind::kDelay:
      FaultSleepMs(d.param_ms, nullptr);
      break;
    case FaultKind::kCorrupt:
      if (corrupt) *corrupt = d;
      break;
    case FaultKind::kNone:
      break;
  }
  return kOk;
}
}  // namespace

int LocalTransport::Read(int target, const std::string& name, int64_t offset,
                         int64_t nbytes, void* dst) {
  Store* peer = group_->member(target);
  if (!peer) return kErrTransport;
  // Drawn as the TARGET rank: the injected fault models the PEER's serve
  // path failing, matching the TCP side (and the DDSTORE_FAULT_RANKS
  // filter's "inject when these ranks serve" semantics).
  FaultDecision corrupt;
  if (int rc = DrawLocalFault(target, &corrupt)) return rc;
  // ReadLocal holds the peer's read lock across the copy, so a concurrent
  // FreeVar on the peer cannot free the shard mid-read.
  const int rc = peer->ReadLocal(name, offset, nbytes, dst);
  if (rc == kOk && corrupt.kind == FaultKind::kCorrupt)
    CorruptBytes(dst, nbytes, corrupt.h | 1, corrupt.param_ms);
  return rc;
}

int64_t LocalTransport::ReadVarSeq(int target, const std::string& name) {
  // Bounded control retry around the ctrl-domain injector draw (the
  // in-process mirror of the TCP side's ControlRoundTrip contract);
  // -1 ("pull unconditionally") is the safe terminal state.
  for (int att = 0;; ++att) {
    if (DrawCtrlFault(target) == kOk) break;
    if (att >= ctrl_retry_max_) return -1;
  }
  Store* peer = group_->member(target);
  return peer ? peer->UpdateSeqOf(name) : -1;
}

int LocalTransport::ReadRowSums(int target, const std::string& name,
                                int64_t row0, int64_t count,
                                int64_t* seq, uint64_t* sums) {
  for (int att = 0;; ++att) {
    if (DrawCtrlFault(target) == kOk) break;
    if (att >= ctrl_retry_max_) return kErrTransport;
  }
  Store* peer = group_->member(target);
  if (!peer) return kErrTransport;
  return peer->RowSums(name, row0, count, sums, seq);
}

int LocalTransport::SnapshotControl(int target, int64_t snap_id,
                                    bool pin, const std::string& tenant) {
  for (int att = 0;; ++att) {
    if (DrawCtrlFault(target) == kOk) break;
    if (att >= ctrl_retry_max_) return kErrTransport;
  }
  Store* peer = group_->member(target);
  // Registered-then-closed is the bounded "peer is gone" signal (the
  // in-process kill vehicle): classify like the TCP side so a mid-
  // placement death engages SnapshotAcquire's partial-pin unwind with
  // kErrPeerLost, not a generic transport error.
  if (!peer)
    return group_->AliveOrPending(target) ? kErrTransport : kErrPeerLost;
  return pin ? peer->PinSnapshot(snap_id, tenant)
             : peer->UnpinSnapshot(snap_id);
}

int LocalTransport::GatewayControl(int target, int verb,
                                   const std::string& tenant,
                                   int64_t arg, int64_t arg2,
                                   int64_t* token_out) {
  if (verb < 0 || verb > 2) return kErrInvalidArg;
  for (int att = 0;; ++att) {
    if (DrawCtrlFault(target) == kOk) break;
    if (att >= ctrl_retry_max_) return kErrTransport;
  }
  Store* peer = group_->member(target);
  // Same death classification as SnapshotControl: a reaped member is
  // kErrPeerLost, a not-yet-registered one a transient failure.
  if (!peer)
    return group_->AliveOrPending(target) ? kErrTransport : kErrPeerLost;
  if (verb == 1) return peer->GatewayRenew(arg);
  if (verb == 2) return peer->GatewayDetach(arg);
  const int64_t token = peer->GatewayAttach(tenant, arg != 0, arg2);
  if (token < 0) return static_cast<int>(token);
  if (token_out) *token_out = token;
  return kOk;
}

int64_t LocalTransport::ReadMetrics(int target, void* out, int64_t cap) {
  for (int att = 0;; ++att) {
    if (DrawCtrlFault(target) == kOk) break;
    if (att >= ctrl_retry_max_) return kErrTransport;
  }
  Store* peer = group_->member(target);
  // Registered-then-closed is the bounded "peer is gone" signal (the
  // in-process kill vehicle) — classified like the TCP suspect
  // short-circuit so a cluster pull skips the corpse cleanly.
  if (!peer)
    return group_->AliveOrPending(target) ? kErrTransport : kErrPeerLost;
  return peer->MetricsSnapshot(out, cap);
}

int LocalTransport::ReadV(int target, const std::string& name,
                          const ReadOp* ops, int64_t n) {
  // Peer resolution and the registry lookup happen once for the batch
  // (the base-class default would pay both per op).
  Store* peer = group_->member(target);
  if (!peer) return kErrTransport;
  FaultDecision corrupt;
  if (int rc = DrawLocalFault(target, &corrupt)) return rc;
  const int rc = peer->ReadLocalV(name, ops, n);
  if (rc == kOk && corrupt.kind == FaultKind::kCorrupt && n > 0) {
    // One op of the batch gets its landed bytes flipped (deterministic
    // pick): the local-memcpy analogue of a corrupted wire frame.
    const ReadOp& op = ops[corrupt.h % static_cast<uint64_t>(n)];
    CorruptBytes(op.dst, op.nbytes, (corrupt.h >> 8) | 1,
                 corrupt.param_ms);
  }
  return rc;
}

}  // namespace dds
