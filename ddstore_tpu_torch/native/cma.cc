#include "cma.h"

#include <dirent.h>
#include <fcntl.h>
#include <sys/prctl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <vector>

namespace dds {
namespace {

// Plain open()/mmap() on /dev/shm instead of shm_open: identical
// semantics on Linux, no librt question on older toolchains.
constexpr char kShmDir[] = "/dev/shm";
constexpr int kIovMax = 1024;  // Linux IOV_MAX
constexpr int kSeqlockRetries = 3;

}  // namespace

uint64_t CmaHash(const std::string& name) {
  uint64_t h = 1469598103934665603ull;
  for (unsigned char c : name) {
    h ^= c;
    h *= 1099511628211ull;
  }
  // 0 marks an empty slot, ~0 a tombstone; neither may be a name hash.
  return (h == 0 || h == kCmaTombstone) ? 1 : h;
}

uint64_t ProcStartTime(int64_t pid) {
  char path[64];
  std::snprintf(path, sizeof(path), "/proc/%ld/stat",
                static_cast<long>(pid));
  std::ifstream f(path);
  std::string line;
  if (!std::getline(f, line)) return 0;
  // comm (field 2) is "(...)" and may itself contain spaces/parens;
  // everything after the LAST ')' is well-formed space-separated fields
  // starting at field 3 (state). starttime is field 22 -> 20th token.
  size_t close = line.rfind(')');
  if (close == std::string::npos) return 0;
  const char* p = line.c_str() + close + 1;
  int field = 2;
  while (*p && field < 21) {
    while (*p == ' ') ++p;
    while (*p && *p != ' ') ++p;
    ++field;
  }
  while (*p == ' ') ++p;
  return *p ? std::strtoull(p, nullptr, 10) : 0;
}

std::string CmaHostToken() {
  std::string boot;
  {
    std::ifstream f("/proc/sys/kernel/random/boot_id");
    std::getline(f, boot);
  }
  char ns[128] = {0};
  ssize_t k = ::readlink("/proc/self/ns/pid", ns, sizeof(ns) - 1);
  if (k < 0) ns[0] = 0;
  return boot + "|" + ns;
}

namespace {

// Unlink /dev/shm files left by dead ddstore processes. Clean teardown
// removes everything (FreeData + the destructor), but a SIGKILL'd
// worker leaks its control segment AND its shard-sized data files —
// tmpfs is host RAM, so repeated unclean restarts would pin it until
// reboot. A control segment is swept only when it provably belongs to
// OUR pid namespace (segment ns_hash matches) and its creator is
// provably gone there (pid's live starttime != the recorded one):
// containers can share a /dev/shm mount without sharing a pid
// namespace, and an other-ns owner's pid being invisible to our /proc
// means "unknowable", not "dead". The dead owner's ".dN" data files
// are unlinked with it. Races between concurrent sweepers are benign
// (ENOENT ignored), and unlinking never invalidates live mappings —
// peers that already mmap'd a file keep their pages.
void SweepDeadOwners() {
  const uint64_t my_ns = CmaHash(CmaHostToken());
  DIR* d = ::opendir(kShmDir);
  if (!d) return;
  std::vector<std::string> names, dead;
  while (dirent* e = ::readdir(d))
    if (std::strncmp(e->d_name, "ddscma.", 7) == 0)
      names.emplace_back(e->d_name);
  ::closedir(d);
  for (const std::string& n : names) {
    long pid = 0;
    // Control segments are "ddscma.<pid>.<hex>" (2 dots); data files
    // append ".d<N>" (3 dots). Count dots — a substring test on ".d"
    // would misclassify any segment whose hex component starts with 'd'.
    if (std::count(n.begin(), n.end(), '.') != 2) continue;
    if (std::sscanf(n.c_str(), "ddscma.%ld.", &pid) != 1 || pid <= 0)
      continue;
    std::string path = std::string(kShmDir) + "/" + n;
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) continue;
    struct stat st;
    bool is_dead = false;
    if (::fstat(fd, &st) == 0 &&
        st.st_size >= static_cast<off_t>(sizeof(CmaSegment))) {
      void* p = ::mmap(nullptr, sizeof(CmaSegment), PROT_READ, MAP_SHARED,
                       fd, 0);
      if (p != MAP_FAILED) {
        auto* seg = static_cast<CmaSegment*>(p);
        is_dead =
            __atomic_load_n(&seg->magic, __ATOMIC_ACQUIRE) == kCmaMagic &&
            seg->ns_hash == my_ns && seg->start_time != 0 &&
            ProcStartTime(seg->pid) != seg->start_time;
        ::munmap(p, sizeof(CmaSegment));
      }
    }
    ::close(fd);
    if (is_dead) dead.push_back(n);
  }
  for (const std::string& n : dead) {
    ::unlink((std::string(kShmDir) + "/" + n).c_str());
    for (const std::string& f : names)
      if (f.size() > n.size() && f.compare(0, n.size(), n) == 0 &&
          f[n.size()] == '.')
        ::unlink((std::string(kShmDir) + "/" + f).c_str());
  }
}

}  // namespace

CmaRegistry::CmaRegistry() {
  SweepDeadOwners();
  char name[96];
  std::snprintf(name, sizeof(name), "ddscma.%ld.%lx",
                static_cast<long>(::getpid()),
                static_cast<unsigned long>(
                    reinterpret_cast<uintptr_t>(this)));
  std::string path = std::string(kShmDir) + "/" + name;
  int fd = ::open(path.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return;
  if (::ftruncate(fd, sizeof(CmaSegment)) != 0) {
    ::close(fd);
    ::unlink(path.c_str());
    return;
  }
  void* p = ::mmap(nullptr, sizeof(CmaSegment), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    ::close(fd);
    ::unlink(path.c_str());
    return;
  }
  seg_ = static_cast<CmaSegment*>(p);
  std::memset(seg_, 0, sizeof(CmaSegment));
  seg_->pid = ::getpid();
  seg_->start_time = ProcStartTime(::getpid());
  seg_->ns_hash = CmaHash(CmaHostToken());
  // magic last: a reader that maps mid-init sees magic==0 and rejects.
  __atomic_store_n(&seg_->magic, kCmaMagic, __ATOMIC_RELEASE);
  shm_name_ = name;
  fd_ = fd;
}

void CmaRegistry::EnableReads() {
  std::call_once(reads_enabled_, [] {
    // Under Yama ptrace_scope=1 (common default) sibling processes get
    // EPERM from process_vm_readv; opt this process into being readable
    // by any same-uid peer. Best effort — scope>=2 still (correctly)
    // demotes peers to TCP via the probe. Process-wide and permanent,
    // which is why it waits for a peer to actually ask (kOpCmaInfo)
    // rather than running at construction.
#ifdef PR_SET_PTRACER
    ::prctl(PR_SET_PTRACER, PR_SET_PTRACER_ANY, 0, 0, 0);
#endif
  });
}

CmaRegistry::~CmaRegistry() {
  // Leftover data files (a Store torn down without FreeAll cannot exist,
  // but belt-and-braces): unmap and unlink so /dev/shm does not leak.
  for (auto& kv : data_) {
    ::munmap(kv.first, static_cast<size_t>(kv.second.len));
    char suffix[32];
    std::snprintf(suffix, sizeof(suffix), ".d%llu",
                  static_cast<unsigned long long>(kv.second.id));
    ::unlink((std::string(kShmDir) + "/" + shm_name_ + suffix).c_str());
  }
  if (seg_) ::munmap(seg_, sizeof(CmaSegment));
  if (fd_ >= 0) ::close(fd_);
  if (!shm_name_.empty())
    ::unlink((std::string(kShmDir) + "/" + shm_name_).c_str());
}

void* CmaRegistry::AllocData(int64_t nbytes, uint64_t* id) {
  if (!seg_ || nbytes <= 0) return nullptr;
  std::lock_guard<std::mutex> lock(mu_);
  const uint64_t next = next_data_id_ + 1;  // ids start at 1; 0 = "no file"
  char suffix[32];
  std::snprintf(suffix, sizeof(suffix), ".d%llu",
                static_cast<unsigned long long>(next));
  std::string path = std::string(kShmDir) + "/" + shm_name_ + suffix;
  int fd = ::open(path.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  // posix_fallocate, not ftruncate: ftruncate reserves no tmpfs pages,
  // so a /dev/shm too full for the shard would surface later as SIGBUS
  // on first write instead of engaging the caller's malloc fallback
  // here. Eager reservation costs nothing extra — owned shards are
  // always fully written (Add's copy or Init's zero-fill).
  if (::posix_fallocate(fd, 0, nbytes) != 0) {
    ::close(fd);
    ::unlink(path.c_str());
    return nullptr;
  }
  void* p = ::mmap(nullptr, static_cast<size_t>(nbytes),
                   PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);  // the mapping keeps the file's pages alive
  if (p == MAP_FAILED) {
    ::unlink(path.c_str());
    return nullptr;
  }
  next_data_id_ = next;
  data_[p] = DataFile{next, nbytes};
  *id = next;
  return p;
}

bool CmaRegistry::FreeData(void* base) {
  if (!seg_) return false;
  std::lock_guard<std::mutex> lock(mu_);
  auto it = data_.find(base);
  if (it == data_.end()) return false;
  char suffix[32];
  std::snprintf(suffix, sizeof(suffix), ".d%llu",
                static_cast<unsigned long long>(it->second.id));
  ::munmap(base, static_cast<size_t>(it->second.len));
  ::unlink((std::string(kShmDir) + "/" + shm_name_ + suffix).c_str());
  data_.erase(it);
  return true;
}

CmaSlot* CmaRegistry::FindSlot(uint64_t h, bool take_empty) {
  // An existing entry for `h` always wins; otherwise the first tombstone
  // or empty slot on the probe path is reusable. Insertion never skips
  // past a true empty (nothing for `h` can live beyond it).
  CmaSlot* insert = nullptr;
  for (int probe = 0; probe < kCmaSlots; ++probe) {
    CmaSlot& s = seg_->slots[(h + probe) % kCmaSlots];
    uint64_t sh = s.hash.load(std::memory_order_relaxed);
    if (sh == h) return &s;
    if (sh == kCmaTombstone) {
      if (take_empty && !insert) insert = &s;
      continue;
    }
    if (sh == 0) {
      if (take_empty && !insert) insert = &s;
      break;
    }
  }
  return insert;  // nullptr: absent (or table full — no fast path)
}

void CmaRegistry::Publish(const std::string& name, const void* base,
                          int64_t len) {
  if (!seg_) return;
  std::lock_guard<std::mutex> lock(mu_);
  uint64_t h = CmaHash(name);
  CmaSlot* s = FindSlot(h, /*take_empty=*/true);
  if (!s) return;
  // AllocData-backed shards advertise their data-file id (offset 0):
  // peers map the file and gather with memcpy. Anything else (borrowed
  // caller buffers, post-spill mmaps) advertises the raw address for the
  // process_vm_readv path.
  uint64_t shm_id = 0, addr = reinterpret_cast<uint64_t>(base);
  auto it = data_.find(const_cast<void*>(base));
  if (it != data_.end()) {
    shm_id = it->second.id;
    addr = 0;
  }
  s->gen.fetch_add(1, std::memory_order_acq_rel);  // odd: mutating
  s->hash.store(h, std::memory_order_relaxed);
  s->shm_id.store(shm_id, std::memory_order_relaxed);
  s->base.store(addr, std::memory_order_relaxed);
  s->len.store(static_cast<uint64_t>(len), std::memory_order_relaxed);
  s->gen.fetch_add(1, std::memory_order_acq_rel);  // even: stable
}

void CmaRegistry::Unpublish(const std::string& name) {
  if (!seg_) return;
  std::lock_guard<std::mutex> lock(mu_);
  CmaSlot* s = FindSlot(CmaHash(name), /*take_empty=*/false);
  if (!s) return;
  s->gen.fetch_add(1, std::memory_order_acq_rel);
  s->hash.store(kCmaTombstone, std::memory_order_relaxed);
  s->shm_id.store(0, std::memory_order_relaxed);
  s->len.store(0, std::memory_order_relaxed);
  s->gen.fetch_add(1, std::memory_order_acq_rel);
}

CmaPeer* CmaPeer::Open(const std::string& shm_name, int64_t pid,
                       uint64_t start_time) {
  if (shm_name.empty() || shm_name.find('/') != std::string::npos)
    return nullptr;
  std::string path = std::string(kShmDir) + "/" + shm_name;
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  void* p = ::mmap(nullptr, sizeof(CmaSegment), PROT_READ, MAP_SHARED,
                   fd, 0);
  ::close(fd);  // the mapping keeps the segment alive
  if (p == MAP_FAILED) return nullptr;
  auto* seg = static_cast<CmaSegment*>(p);
  // Three-way identity check: the segment must have been created by the
  // advertised (pid, starttime), and that pid must STILL be that process
  // per the live /proc entry — a stale segment whose pid was recycled to
  // an unrelated process fails here instead of being read.
  if (__atomic_load_n(&seg->magic, __ATOMIC_ACQUIRE) != kCmaMagic ||
      seg->pid != pid || start_time == 0 ||
      seg->start_time != start_time ||
      ProcStartTime(pid) != start_time) {
    ::munmap(p, sizeof(CmaSegment));
    return nullptr;
  }
  return new CmaPeer(seg, sizeof(CmaSegment), pid, start_time, shm_name);
}

const CmaPeer::DataMap* CmaPeer::EnsureDataMap(uint64_t id) {
  std::lock_guard<std::mutex> lock(maps_mu_);
  // Opportunistic release: an unpinned mapping whose backing file the
  // owner has unlinked (spill to disk, FreeVar, republish) is pinning
  // tmpfs pages nothing can ever read again — ids are never reused.
  // One stat per cached mapping per call; variables are few.
  for (auto it = maps_.begin(); it != maps_.end();) {
    if (it->first != id && it->second.base && it->second.pins == 0) {
      char sfx[32];
      std::snprintf(sfx, sizeof(sfx), ".d%llu",
                    static_cast<unsigned long long>(it->first));
      struct stat st;
      if (::stat((std::string(kShmDir) + "/" + shm_name_ + sfx).c_str(),
                 &st) != 0 &&
          errno == ENOENT) {
        ::munmap(it->second.base, static_cast<size_t>(it->second.len));
        it = maps_.erase(it);
        continue;
      }
    }
    ++it;
  }
  auto it = maps_.find(id);
  if (it != maps_.end()) {
    if (!it->second.base) return nullptr;
    ++it->second.pins;
    return &it->second;
  }
  char suffix[32];
  std::snprintf(suffix, sizeof(suffix), ".d%llu",
                static_cast<unsigned long long>(id));
  std::string path = std::string(kShmDir) + "/" + shm_name_ + suffix;
  DataMap m{nullptr, 0, 0};
  bool transient = false;
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd >= 0) {
    struct stat st;
    if (::fstat(fd, &st) == 0 && st.st_size > 0) {
      void* p = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                       MAP_SHARED, fd, 0);
      if (p != MAP_FAILED) {
        m.base = static_cast<char*>(p);
        m.len = static_cast<int64_t>(st.st_size);
      } else {
        transient = errno == ENOMEM || errno == EAGAIN;
      }
    }
    ::close(fd);
  } else {
    transient =
        errno == EMFILE || errno == ENFILE || errno == EINTR ||
        errno == ENOMEM;
  }
  // Deterministic negative results are cached (a file unlinked by the
  // owner or unreadable by policy will not become mappable under this
  // id — ids are never reused — so per-read retries would be pure
  // overhead), but resource-exhaustion failures (fd limit, memory
  // pressure) are NOT: caching one would silently demote this variable
  // to TCP for the peer's whole lifetime over a momentary spike.
  if (transient) return nullptr;
  it = maps_.emplace(id, m).first;
  if (!it->second.base) return nullptr;
  ++it->second.pins;
  return &it->second;
}

void CmaPeer::ReleaseDataMap(uint64_t id) {
  std::lock_guard<std::mutex> lock(maps_mu_);
  auto it = maps_.find(id);
  if (it != maps_.end() && it->second.pins > 0) --it->second.pins;
}

bool CmaPeer::PeerStillAlive() {
  if (ProcStartTime(pid_) == start_time_) return true;
  denied_.store(true, std::memory_order_relaxed);
  return false;
}

bool CmaPeer::LiveRecently() {
  timespec ts;
  ::clock_gettime(CLOCK_MONOTONIC_COARSE, &ts);
  const int64_t now =
      static_cast<int64_t>(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
  const int64_t last = last_live_ns_.load(std::memory_order_relaxed);
  if (last != 0 && now - last < 200000000ll) return true;  // < 200 ms old
  // Racing threads may all slip past the window check and re-probe /proc
  // concurrently; that is harmless (same verdict), so no CAS needed.
  last_live_ns_.store(now, std::memory_order_relaxed);
  return PeerStillAlive();
}

CmaPeer::~CmaPeer() {
  for (auto& kv : maps_)
    if (kv.second.base)
      ::munmap(kv.second.base, static_cast<size_t>(kv.second.len));
  if (seg_) ::munmap(seg_, map_len_);
}

int CmaPeer::TryReadV(const std::string& name, const ReadOp* ops,
                      int64_t n) {
  if (denied_.load(std::memory_order_relaxed)) return kCmaFallback;
  // Cheap periodic liveness recheck (pid-recycle guard): once every 4096
  // calls, confirm the pid still belongs to the segment's creator.
  if ((reads_since_check_.fetch_add(1, std::memory_order_relaxed) &
       4095) == 4095 &&
      !PeerStillAlive())
    return kCmaFallback;
  const uint64_t h = CmaHash(name);
  // Reader-side probe mirrors FindSlot.
  CmaSlot* slot = nullptr;
  for (int probe = 0; probe < kCmaSlots; ++probe) {
    CmaSlot& s = seg_->slots[(h + probe) % kCmaSlots];
    uint64_t sh = s.hash.load(std::memory_order_acquire);
    if (sh == h) {
      slot = &s;
      break;
    }
    if (sh == kCmaTombstone) continue;  // freed slot: probe past it
    if (sh == 0) break;  // linear-probe chain ends at first true empty
  }
  if (!slot) return kCmaFallback;

  // Shm-mapped fast path: the owner's shard lives in a /dev/shm file we
  // can map once and gather from with plain memcpy — no per-segment
  // syscall or sentry cost at all, which is what lets small-row batched
  // reads run at bulk bandwidth. The seqlock contract is identical to
  // the pvm path: bytes only count when the generation is even and
  // unchanged across the whole gather.
  for (int attempt = 0; attempt < kSeqlockRetries; ++attempt) {
    const uint64_t g1 = slot->gen.load(std::memory_order_acquire);
    if (g1 & 1) continue;  // mutation in progress; re-snapshot
    const uint64_t shm_id = slot->shm_id.load(std::memory_order_relaxed);
    if (shm_id == 0) break;  // raw-address mode: pvm path below
    if (slot->hash.load(std::memory_order_relaxed) != h) break;
    // Liveness gate (throttled): our mapping pins the data file's pages,
    // so without this a dead peer's gather would keep "succeeding" and
    // peer death would never surface. Dead -> denied_ -> TCP, whose
    // reconnect/read produces the bounded DDStoreError.
    if (!LiveRecently()) return kCmaFallback;
    const uint64_t off0 = slot->base.load(std::memory_order_relaxed);
    const uint64_t len = slot->len.load(std::memory_order_relaxed);
    const DataMap* m = EnsureDataMap(shm_id);
    if (!m) return kCmaFallback;  // shm-backed but unmappable: use TCP
    // Pin held for the whole gather: the opportunistic sweep in
    // EnsureDataMap must not munmap pages a concurrent (or this) thread
    // is still memcpying from.
    if (off0 > static_cast<uint64_t>(m->len) ||
        len > static_cast<uint64_t>(m->len) - off0) {
      ReleaseDataMap(shm_id);
      return kCmaFallback;
    }
    const char* src = m->base + off0;
    bool bad = false;
    for (int64_t i = 0; i < n && !bad; ++i) {
      const ReadOp& op = ops[i];
      if (op.nbytes < 0 || op.offset < 0 ||
          static_cast<uint64_t>(op.offset) > len ||
          static_cast<uint64_t>(op.nbytes) >
              len - static_cast<uint64_t>(op.offset)) {
        bad = true;  // stale/foreign mapping — let TCP produce the error
        break;
      }
      if (op.nbytes)
        std::memcpy(op.dst, src + op.offset,
                    static_cast<size_t>(op.nbytes));
    }
    const bool stable =
        !bad && slot->gen.load(std::memory_order_acquire) == g1;
    ReleaseDataMap(shm_id);
    if (bad) return kCmaFallback;
    if (stable) return kOk;
    // generation bounced mid-gather (owner Update/Rebind): retry, then
    // hand the request to TCP, where the store lock serializes it.
  }

  std::vector<iovec> liov, riov;
  for (int64_t begin = 0; begin < n;) {
    const int64_t end = std::min(n, begin + kIovMax);
    bool done = false;
    for (int attempt = 0; attempt < kSeqlockRetries && !done; ++attempt) {
      const uint64_t g1 = slot->gen.load(std::memory_order_acquire);
      if (g1 & 1) continue;  // mutation in progress
      if (slot->shm_id.load(std::memory_order_relaxed) != 0)
        return kCmaFallback;  // shm-backed but unmappable here: use TCP
      const uint64_t base = slot->base.load(std::memory_order_relaxed);
      const uint64_t len = slot->len.load(std::memory_order_relaxed);
      if (slot->hash.load(std::memory_order_relaxed) != h) break;

      int64_t want = 0;
      liov.clear();
      riov.clear();
      bool bad = false;
      for (int64_t i = begin; i < end; ++i) {
        const ReadOp& op = ops[i];
        if (op.nbytes < 0 || op.offset < 0 ||
            static_cast<uint64_t>(op.offset) > len ||
            static_cast<uint64_t>(op.nbytes) >
                len - static_cast<uint64_t>(op.offset)) {
          bad = true;  // stale/foreign mapping — let TCP produce the error
          break;
        }
        if (op.nbytes == 0) continue;
        liov.push_back(iovec{op.dst, static_cast<size_t>(op.nbytes)});
        riov.push_back(iovec{
            reinterpret_cast<void*>(base + static_cast<uint64_t>(op.offset)),
            static_cast<size_t>(op.nbytes)});
        want += op.nbytes;
      }
      if (bad) break;
      ssize_t got = want == 0
                        ? 0
                        : ::process_vm_readv(static_cast<pid_t>(pid_),
                                             liov.data(), liov.size(),
                                             riov.data(), riov.size(), 0);
      if (got < 0 && (errno == EPERM || errno == ESRCH)) {
        denied_.store(true, std::memory_order_relaxed);
        return kCmaFallback;
      }
      const uint64_t g2 = slot->gen.load(std::memory_order_acquire);
      if (got == want && g1 == g2) done = true;
      // else: generation bounced or mapping went away mid-read — the
      // bytes may be garbage; retry, then fall back.
    }
    if (!done) {
      // A failed read is the moment a recycled pid would first show up
      // (the old mapping's addresses usually aren't valid in the new
      // process): revalidate so a dead peer demotes to TCP permanently.
      PeerStillAlive();
      return kCmaFallback;
    }
    begin = end;
  }
  return kOk;
}

}  // namespace dds
