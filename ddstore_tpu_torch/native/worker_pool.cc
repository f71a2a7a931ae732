#include "worker_pool.h"

#include "trace.h"

namespace dds {

WorkerPool::WorkerPool(int max_threads)
    : max_threads_(max_threads < 1 ? 1 : max_threads) {}

WorkerPool::~WorkerPool() {
  {
    std::lock_guard<std::mutex> lock(mu_);
    stopping_ = true;
  }
  cv_.notify_all();
  for (auto& t : threads_)
    if (t.joinable()) t.join();
}

void WorkerPool::Submit(std::function<void()> fn) {
  {
    std::lock_guard<std::mutex> lock(mu_);
    queue_.push_back(std::move(fn));
    // Grow on queue depth, not zero-idle: a woken worker only decrements
    // idle_ after re-acquiring the mutex, so a burst of submits would see
    // a stale idle count and under-provision a network-bound fan-out.
    if (static_cast<int64_t>(queue_.size()) > idle_ &&
        static_cast<int>(threads_.size()) < max_threads_)
      threads_.emplace_back([this] { WorkerLoop(); });
  }
  cv_.notify_one();
}

void WorkerPool::SubmitMany(std::vector<std::function<void()>> fns) {
  if (fns.empty()) return;
  {
    std::lock_guard<std::mutex> lock(mu_);
    for (auto& fn : fns) queue_.push_back(std::move(fn));
    // Same growth rule as Submit, applied for the whole burst under one
    // lock: a lane-striped fan-out (peers × lanes leaves) provisions
    // its width in one pass instead of one lock+notify round-trip per
    // leaf.
    int64_t avail = idle_;  // idle workers + threads spawned this burst
    while (static_cast<int64_t>(queue_.size()) > avail &&
           static_cast<int>(threads_.size()) < max_threads_) {
      threads_.emplace_back([this] { WorkerLoop(); });
      ++avail;
    }
  }
  cv_.notify_all();
}

void WorkerPool::WorkerLoop() {
  std::unique_lock<std::mutex> lock(mu_);
  for (;;) {
    while (queue_.empty() && !stopping_) {
      ++idle_;
      cv_.wait(lock);
      --idle_;
    }
    if (queue_.empty() && stopping_) return;
    auto fn = std::move(queue_.front());
    queue_.pop_front();
    lock.unlock();
    fn();
    lock.lock();
  }
}

TaskGroup::TaskGroup(WorkerPool* pool)
    : pool_(pool), state_(std::make_shared<State>()) {}

void TaskGroup::Launch(std::function<void()> fn) {
  {
    std::lock_guard<std::mutex> lock(state_->mu);
    ++state_->pending;
  }
  // Trace-span propagation: a leaf runs under the SUBMITTER's span so
  // lane dials, retries and serve legs attribute to the op that caused
  // them. Identity (one relaxed load) when tracing is off.
  fn = trace::TraceTask(std::move(fn));
  pool_->Submit([st = state_, fn = std::move(fn)]() {
    fn();
    // notify under the lock: the waiter can destroy the TaskGroup the
    // moment Wait() returns, but `st` keeps the State alive here.
    std::lock_guard<std::mutex> lock(st->mu);
    if (--st->pending == 0) st->cv.notify_all();
  });
}

void TaskGroup::LaunchMany(std::vector<std::function<void()>> fns) {
  if (fns.empty()) return;
  {
    std::lock_guard<std::mutex> lock(state_->mu);
    state_->pending += static_cast<int64_t>(fns.size());
  }
  std::vector<std::function<void()>> wrapped;
  wrapped.reserve(fns.size());
  for (auto& fn : fns)
    wrapped.emplace_back([st = state_,
                          fn = trace::TraceTask(std::move(fn))]() {
      fn();
      std::lock_guard<std::mutex> lock(st->mu);
      if (--st->pending == 0) st->cv.notify_all();
    });
  pool_->SubmitMany(std::move(wrapped));
}

void TaskGroup::Wait() {
  std::unique_lock<std::mutex> lock(state_->mu);
  state_->cv.wait(lock, [this] { return state_->pending == 0; });
}

}  // namespace dds
