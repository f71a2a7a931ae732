#include "tier.h"

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <cstring>

namespace dds {
namespace tier {

void HotRowCache::Configure(int64_t max_bytes) {
  if (max_bytes < 0) return;
  max_bytes_.store(max_bytes, std::memory_order_relaxed);
}

std::shared_ptr<Entry> HotRowCache::Begin(const std::string& name,
                                          const int64_t* rows, int64_t n,
                                          int64_t row_bytes,
                                          int64_t window,
                                          const std::string& tenant,
                                          int64_t quota_charged) {
  const int64_t cap = max_bytes_.load(std::memory_order_relaxed);
  if (cap <= 0 || !rows || n <= 0 || row_bytes <= 0) return nullptr;
  // The serve-side density check binary-searches the row list: an
  // unsorted (or duplicated) list would let it certify a run whose
  // middle rows are NOT present — wrong bytes served. Refuse instead
  // (the window planner always hands sorted-unique rows).
  for (int64_t i = 1; i < n; ++i)
    if (rows[i] <= rows[i - 1]) return nullptr;
  const int64_t bytes = n * row_bytes;
  // Build (and allocate) OUTSIDE the lock: a multi-MB window buffer's
  // first-touch must not serialize concurrent serves. A refusal below
  // just drops the entry (and its buffer) on the floor.
  auto e = std::make_shared<Entry>();
  e->name = name;
  e->window = window;
  e->row_bytes = row_bytes;
  e->rows.assign(rows, rows + n);
  // Quota fields armed BEFORE publication: an evict racing the
  // prefetch releases the charge through the entry it removed.
  e->tenant = tenant;
  e->quota_charged = quota_charged;
  if (quota_charged > 0)
    e->quota_live.store(true, std::memory_order_release);
  e->buf.reset(new (std::nothrow) char[static_cast<size_t>(bytes)]);
  if (!e->buf) {
    cnt_.over_budget.fetch_add(1, std::memory_order_relaxed);
    return nullptr;
  }
  const auto key = std::make_pair(name, window);
  {
    std::lock_guard<std::mutex> lock(mu_);
    if (entries_.count(key)) return nullptr;  // already warmed: no-op
    if (charged_ + bytes > cap) {
      cnt_.over_budget.fetch_add(1, std::memory_order_relaxed);
      return nullptr;
    }
    charged_ += bytes;
    entries_.emplace(key, e);
  }
  return e;
}

void HotRowCache::RemoveLocked(
    std::map<std::pair<std::string, int64_t>,
             std::shared_ptr<Entry>>::iterator it) {
  Entry& e = *it->second;
  if (e.charged) {
    e.charged = false;
    charged_ -= e.bytes();
    if (charged_ < 0) charged_ = 0;
  }
  entries_.erase(it);
}

void HotRowCache::Commit(const std::shared_ptr<Entry>& e, bool ok) {
  if (!e) return;
  // State published BEFORE any serve can see the entry as ready; the
  // release store pairs with ServeRun's acquire load so the fill's
  // writes into buf are visible to the serving memcpy.
  e->state.store(ok ? Entry::kReady : Entry::kFailed,
                 std::memory_order_release);
  if (ok) {
    cnt_.fills.fetch_add(1, std::memory_order_relaxed);
    cnt_.fill_bytes.fetch_add(e->bytes(), std::memory_order_relaxed);
    return;
  }
  cnt_.fill_failures.fetch_add(1, std::memory_order_relaxed);
  // A failed fill's slot is useless: remove it (budget released
  // exactly once — an eviction that raced us already flipped
  // `charged`, and the erase below then finds a different or missing
  // entry and does nothing).
  std::lock_guard<std::mutex> lock(mu_);
  auto it = entries_.find(std::make_pair(e->name, e->window));
  if (it != entries_.end() && it->second == e) RemoveLocked(it);
}

bool HotRowCache::ServeRun(const std::string& name, int64_t row0,
                           int64_t nrows, int64_t row_bytes, char* dst) {
  if (nrows <= 0) return false;
  std::shared_ptr<Entry> hit;
  size_t pos = 0;
  {
    std::lock_guard<std::mutex> lock(mu_);
    // Entries of one name are contiguous in the (name, window) map;
    // the readahead pipeline keeps only a handful live at once.
    for (auto it = entries_.lower_bound(std::make_pair(name, INT64_MIN));
         it != entries_.end() && it->first.first == name; ++it) {
      Entry& e = *it->second;
      if (e.state.load(std::memory_order_acquire) != Entry::kReady)
        continue;
      if (e.row_bytes != row_bytes) continue;  // re-registered geometry
      auto lb = std::lower_bound(e.rows.begin(), e.rows.end(), row0);
      if (lb == e.rows.end() || *lb != row0) continue;
      const size_t p = static_cast<size_t>(lb - e.rows.begin());
      if (p + nrows > e.rows.size()) continue;
      // Sorted unique rows: the run is fully, densely present iff the
      // last row sits exactly nrows-1 slots later.
      if (e.rows[p + nrows - 1] != row0 + nrows - 1) continue;
      hit = it->second;
      pos = p;
      break;
    }
  }
  const int64_t bytes = nrows * row_bytes;
  if (!hit) {
    cnt_.misses.fetch_add(1, std::memory_order_relaxed);
    cnt_.miss_bytes.fetch_add(bytes, std::memory_order_relaxed);
    return false;
  }
  // Copy outside the lock: the shared_ptr keeps the buffer alive
  // across a concurrent eviction, which is the race the ASan stress
  // block hammers.
  std::memcpy(dst, hit->buf.get() + pos * row_bytes,
              static_cast<size_t>(bytes));
  cnt_.hits.fetch_add(1, std::memory_order_relaxed);
  cnt_.hit_bytes.fetch_add(bytes, std::memory_order_relaxed);
  return true;
}

int HotRowCache::Evict(int64_t window,
                       std::vector<std::shared_ptr<Entry>>* out) {
  int n = 0;
  std::lock_guard<std::mutex> lock(mu_);
  for (auto it = entries_.begin(); it != entries_.end();) {
    if (window >= 0 && it->first.second != window) {
      ++it;
      continue;
    }
    if (out) out->push_back(it->second);
    cnt_.evictions.fetch_add(1, std::memory_order_relaxed);
    cnt_.evicted_bytes.fetch_add(it->second->bytes(),
                                 std::memory_order_relaxed);
    auto victim = it++;
    RemoveLocked(victim);
    ++n;
  }
  return n;
}

void HotRowCache::DropVar(const std::string& name,
                          std::vector<std::shared_ptr<Entry>>* out) {
  std::lock_guard<std::mutex> lock(mu_);
  for (auto it = entries_.lower_bound(std::make_pair(name, INT64_MIN));
       it != entries_.end() && it->first.first == name;) {
    if (out) out->push_back(it->second);
    cnt_.evictions.fetch_add(1, std::memory_order_relaxed);
    cnt_.evicted_bytes.fetch_add(it->second->bytes(),
                                 std::memory_order_relaxed);
    auto victim = it++;
    RemoveLocked(victim);
  }
}

void HotRowCache::Stats(int64_t out[13]) const {
  out[0] = cnt_.hits.load(std::memory_order_relaxed);
  out[1] = cnt_.hit_bytes.load(std::memory_order_relaxed);
  out[2] = cnt_.misses.load(std::memory_order_relaxed);
  out[3] = cnt_.miss_bytes.load(std::memory_order_relaxed);
  out[4] = cnt_.fills.load(std::memory_order_relaxed);
  out[5] = cnt_.fill_bytes.load(std::memory_order_relaxed);
  out[6] = cnt_.fill_failures.load(std::memory_order_relaxed);
  out[7] = cnt_.evictions.load(std::memory_order_relaxed);
  out[8] = cnt_.evicted_bytes.load(std::memory_order_relaxed);
  out[9] = cnt_.over_budget.load(std::memory_order_relaxed);
  out[10] = cnt_.prefetches.load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(mu_);
  out[11] = charged_;
  out[12] = static_cast<int64_t>(entries_.size());
}

void* ColdAlloc(const std::string& dir, int64_t bytes) {
  if (dir.empty() || bytes < 0) return nullptr;
  char path[4096];
  static std::atomic<uint64_t> seq{0};
  std::snprintf(path, sizeof(path), "%s/ddstore-cold-%ld-%llu.bin",
                dir.c_str(), static_cast<long>(::getpid()),
                static_cast<unsigned long long>(
                    seq.fetch_add(1, std::memory_order_relaxed)));
  const int fd = ::open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd < 0) return nullptr;
  // Unlink immediately: the mapping keeps the inode alive, the disk
  // space is reclaimed the moment the mapping (or the process) dies —
  // no free-path or crash can leak cold files.
  ::unlink(path);
  const size_t len = bytes > 0 ? static_cast<size_t>(bytes) : 1;
  if (::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base =
      ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);  // the mapping holds its own reference
  return base == MAP_FAILED ? nullptr : base;
}

void ColdFree(void* base, int64_t bytes) {
  if (!base) return;
  ::munmap(base, bytes > 0 ? static_cast<size_t>(bytes) : 1);
}

}  // namespace tier
}  // namespace dds
