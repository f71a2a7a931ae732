// Persistent worker pool for the transport hot path.
//
// Round 1 spawned a fresh std::thread per remote peer per GetBatch call and
// another per connection per striped ReadV — thread creation/join on every
// batch (the TCP analogue of the reference's per-call fi_mr_reg cliff,
// reference src/common.cxx:314-323, which SURVEY §7 flags as the
// anti-pattern to not reproduce). This pool keeps a small set of persistent
// threads; callers submit leaf tasks through a TaskGroup and wait on a
// counter. Tasks never submit nested tasks that are themselves waited on
// from inside the pool (the batched-read path flattens peer×connection
// fan-out into one task list first), so the pool cannot self-deadlock; the
// submitting thread additionally runs one task inline, guaranteeing
// progress even with zero pool threads available.

#ifndef DDSTORE_TPU_WORKER_POOL_H_
#define DDSTORE_TPU_WORKER_POOL_H_

#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include "thread_annotations.h"

namespace dds {

class WorkerPool {
 public:
  // Threads are created lazily, up to `max_threads`, and persist until
  // destruction.
  explicit WorkerPool(int max_threads);
  ~WorkerPool();

  WorkerPool(const WorkerPool&) = delete;
  WorkerPool& operator=(const WorkerPool&) = delete;

  // Enqueue fn; never blocks. Spawns a new persistent thread when all
  // existing ones are busy and the cap allows.
  void Submit(std::function<void()> fn);

  // Enqueue a whole burst under ONE lock acquisition + one broadcast
  // wake, provisioning threads for the burst's width in the same pass —
  // the lane-striped fan-out dispatches peers × lanes leaves at once,
  // where per-leaf lock+notify is measurable overhead.
  void SubmitMany(std::vector<std::function<void()>> fns);

  int max_threads() const { return max_threads_; }

 private:
  void WorkerLoop();

  const int max_threads_;
  // Queue mutex: dispatch hot path (one acquisition per burst), no
  // blocking call may run under it.
  std::mutex mu_ DDS_NO_BLOCKING;
  std::condition_variable cv_;
  std::deque<std::function<void()>> queue_ DDS_GUARDED_BY(mu_);
  std::vector<std::thread> threads_ DDS_GUARDED_BY(mu_);
  int idle_ DDS_GUARDED_BY(mu_) = 0;
  bool stopping_ DDS_GUARDED_BY(mu_) = false;
};

// Tracks a batch of tasks submitted to a pool; Wait() blocks until all
// complete. Reusable after Wait() returns. The counter state is held by
// shared_ptr so an in-flight task's completion can never touch a
// destroyed TaskGroup (the waiter may destroy the group the moment
// Wait() returns).
class TaskGroup {
 public:
  explicit TaskGroup(WorkerPool* pool);

  // Submit fn to the pool as part of this group.
  void Launch(std::function<void()> fn);
  // Submit a burst as one batch (WorkerPool::SubmitMany).
  void LaunchMany(std::vector<std::function<void()>> fns);
  // Block until every launched task has finished.
  void Wait();

 private:
  struct State {
    std::mutex mu;  // no blocking under it: completion-count bumps only
    std::condition_variable cv;
    int64_t pending DDS_GUARDED_BY(State::mu) = 0;
  };
  WorkerPool* pool_;
  std::shared_ptr<State> state_;
};

}  // namespace dds

#endif  // DDSTORE_TPU_WORKER_POOL_H_
