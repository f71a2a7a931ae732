#include "tcp_transport.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>

#include "trace.h"
#include "wire.h"

namespace dds {
namespace {

// Framing constants + WireReq/WireResp moved to wire.h (shared with the
// io_uring backend, which must emit the identical byte stream). Pulled
// into this anonymous namespace so every pre-existing unqualified
// reference below still resolves.
using namespace wire;  // NOLINT

int FullSend(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return 0;
}

int FullRecv(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return -1;
    }
    p += k;
    n -= static_cast<size_t>(k);
  }
  return 0;
}

// Buffered request reader for the serving loop. Pipelined clients
// gather many frame requests into ONE vectored send; reading each
// frame's header/name/op-list with separate recv syscalls would pay ~3
// syscalls per frame (hot on sandboxed kernels). The buffer drains a
// whole request burst with one recv and hands out pieces by memcpy;
// response traffic never goes through it, so sends stay unbuffered.
struct ReqReader {
  explicit ReqReader(int fd) : fd_(fd), buf_(64 << 10) {}
  int Read(void* dst, size_t n) {
    char* out = static_cast<char*>(dst);
    while (n > 0) {
      if (pos_ < len_) {
        const size_t k = std::min(n, len_ - pos_);
        std::memcpy(out, buf_.data() + pos_, k);
        pos_ += k;
        out += k;
        n -= k;
        continue;
      }
      if (n >= buf_.size()) return FullRecv(fd_, out, n);
      pos_ = len_ = 0;
      const ssize_t k = ::recv(fd_, buf_.data(), buf_.size(), 0);
      if (k <= 0) {
        if (k < 0 && errno == EINTR) continue;
        return -1;
      }
      len_ = static_cast<size_t>(k);
    }
    return 0;
  }

 private:
  int fd_;
  std::vector<char> buf_;
  size_t pos_ = 0, len_ = 0;
};

void SetNoDelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Bulk shard reads are bandwidth-bound; default socket buffers cap
// loopback/DCN throughput well below line rate. Per tcp(7) this must be
// applied BEFORE connect() on clients and on the LISTEN socket (accepted
// sockets inherit it) for the window scale to be negotiated accordingly.
void SetBufSizes(int fd) {
  int buf = 1 << 22;
  ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
}

// Same-host fast lane: abstract-namespace Unix socket address, named by
// the instance's TCP port. The TCP bind owns that port exclusively
// within the network namespace, and abstract socket names live in the
// SAME namespace, so the derived name is collision-free across
// instances and needs no filesystem path or cleanup.
socklen_t UdsAddr(int port, sockaddr_un* sa) {
  std::memset(sa, 0, sizeof(*sa));
  sa->sun_family = AF_UNIX;
  int n = std::snprintf(sa->sun_path + 1, sizeof(sa->sun_path) - 1,
                        "ddstore.%d", port);
  return static_cast<socklen_t>(
      offsetof(sockaddr_un, sun_path) + 1 + static_cast<size_t>(n));
}

// DDSTORE_UDS=0 turns the fast lane off (both the listener and dialing).
bool UdsEnabled() {
  const char* env = ::getenv("DDSTORE_UDS");
  return !env || std::strtol(env, nullptr, 10) != 0;
}

// Only loopback-addressed peers dial the Unix lane: for any other
// address the port-derived name could belong to a DIFFERENT host's
// ddstore instance that happens to share the port number.
bool LoopbackHost(const std::string& h) {
  return h == "localhost" || h.compare(0, 4, "127.") == 0;
}

// Send an iovec array as one vectored stream (one syscall in the common
// case; matters for the many-small-rows read pattern). Mutates `iov` to
// track partial progress. sendmsg + MSG_NOSIGNAL, not writev: a peer
// closing mid-write must surface as an error, not a process-killing
// SIGPIPE. `deadline_s`, when nonzero, bounds the WHOLE send against
// CLOCK_MONOTONIC: SO_SNDTIMEO only bounds each sendmsg call, so a
// client that drains a trickle per timeout window could otherwise pin
// the caller (and, in the serving loop, the store's shared lock)
// indefinitely.
int SendIov(int fd, iovec* iov, int cnt, double deadline_s = 0.0) {
  int idx = 0;
  while (idx < cnt) {
    if (iov[idx].iov_len == 0) {
      ++idx;
      continue;
    }
    if (deadline_s > 0.0) {
      timespec ts;
      ::clock_gettime(CLOCK_MONOTONIC, &ts);
      if (ts.tv_sec + ts.tv_nsec * 1e-9 > deadline_s) return -1;
    }
    msghdr msg;
    std::memset(&msg, 0, sizeof(msg));
    msg.msg_iov = &iov[idx];
    msg.msg_iovlen = std::min(static_cast<size_t>(cnt - idx), kIovMax);
    ssize_t k = ::sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (k < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    size_t done = static_cast<size_t>(k);
    while (idx < cnt && done >= iov[idx].iov_len) {
      done -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < cnt && done) {
      iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + done;
      iov[idx].iov_len -= done;
    }
  }
  return 0;
}

int SendVec(int fd, const void* hdr, size_t hdr_len, const void* payload,
            size_t pay_len) {
  iovec iov[2];
  iov[0].iov_base = const_cast<void*>(hdr);
  iov[0].iov_len = hdr_len;
  iov[1].iov_base = const_cast<void*>(payload);
  iov[1].iov_len = pay_len;
  return SendIov(fd, iov, 2);
}

// Receive a byte stream scattered straight into an iovec array (the
// client side of a vectored-read response: each op's slice lands in its
// final destination buffer with no intermediate copy). Mutates `iov`.
int RecvScatter(int fd, iovec* iov, int cnt) {
  int idx = 0;
  while (idx < cnt) {
    if (iov[idx].iov_len == 0) {
      ++idx;
      continue;
    }
    msghdr msg;
    std::memset(&msg, 0, sizeof(msg));
    msg.msg_iov = &iov[idx];
    msg.msg_iovlen = std::min(static_cast<size_t>(cnt - idx), kIovMax);
    ssize_t k = ::recvmsg(fd, &msg, 0);
    if (k <= 0) {
      if (k < 0 && errno == EINTR) continue;
      return -1;
    }
    size_t done = static_cast<size_t>(k);
    while (idx < cnt && done >= iov[idx].iov_len) {
      done -= iov[idx].iov_len;
      ++idx;
    }
    if (idx < cnt && done) {
      iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + done;
      iov[idx].iov_len -= done;
    }
  }
  return 0;
}

// DDSTORE_DEBUG=1 narrates barrier traffic to stderr (control-plane bugs
// across processes are otherwise invisible — the reference's equivalent
// pain point is its commented-out printf debugging, ddstore.hpp:90-94).
bool DebugOn() {
  static const bool on = ::getenv("DDSTORE_DEBUG") != nullptr;
  return on;
}

long EnvLong(const char* name, long dflt) {
  if (const char* env = ::getenv(name)) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) return v;
  }
  return dflt;
}

// Split ops into `nlists` round-robin chunk lists of ~`chunk` bytes
// (shared by TCP connection striping and CMA part striping — one loop to
// keep correct). Ops with nbytes <= 0 pass through UNSPLIT so the
// downstream validation still sees and rejects them instead of them
// silently vanishing from every list.
std::vector<std::vector<dds::ReadOp>> DealChunks(const dds::ReadOp* ops,
                                                 int64_t n, int64_t chunk,
                                                 int nlists) {
  std::vector<std::vector<dds::ReadOp>> lists(
      static_cast<size_t>(nlists));
  int next = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (ops[i].nbytes <= 0) {
      lists[static_cast<size_t>(next)].push_back(ops[i]);
      next = (next + 1) % nlists;
      continue;
    }
    int64_t off = ops[i].offset, left = ops[i].nbytes;
    char* dst = static_cast<char*>(ops[i].dst);
    while (left > 0) {
      int64_t take = left < chunk ? left : chunk;
      lists[static_cast<size_t>(next)].push_back(
          dds::ReadOp{off, take, dst});
      next = (next + 1) % nlists;
      off += take;
      dst += take;
      left -= take;
    }
  }
  return lists;
}

}  // namespace

TcpTransport::TcpTransport(int rank, int world, int port)
    : rank_(rank), world_(world),
      pool_(static_cast<int>(EnvLong(
          "DDSTORE_POOL_THREADS",
          std::min(64u, std::max(4u, std::thread::hardware_concurrency()))))) {
  listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd_ < 0) return;
  int one = 1;
  ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  // Accepted sockets inherit the listen socket's buffer sizes; this is the
  // point where they must be set for window scaling to be negotiated.
  SetBufSizes(listen_fd_);
  sockaddr_in addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(listen_fd_, 1024) < 0) {
    ::close(listen_fd_);
    listen_fd_ = -1;
    return;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
  server_port_ = ntohs(addr.sin_port);
  accept_thread_ = std::thread([this] { AcceptLoop(listen_fd_, true); });

  // Same-host fast lane: a second listener on the port-derived abstract
  // Unix socket, served by the SAME HandleConnection protocol loop. On
  // the scatter class the stream is CPU-bound on per-byte cost, and the
  // Unix lane skips the (possibly sentry-emulated) TCP/IP stack — a
  // measured ~1.6x per-byte saving on the 2-core bench kernel. Failure
  // to bind (name squatted, AF_UNIX unavailable) just means no fast
  // lane; peers fall back to loopback TCP on their first dial.
  if (UdsEnabled()) {
    int ufd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (ufd >= 0) {
      SetBufSizes(ufd);
      sockaddr_un ua;
      const socklen_t ulen = UdsAddr(server_port_, &ua);
      if (::bind(ufd, reinterpret_cast<sockaddr*>(&ua), ulen) == 0 &&
          ::listen(ufd, 1024) == 0) {
        uds_listen_fd_ = ufd;
        uds_accept_thread_ =
            std::thread([this] { AcceptLoop(uds_listen_fd_, false); });
      } else {
        ::close(ufd);
      }
    }
  }

  // Striping only pays when there are cores to run the extra streams and
  // serving threads (TPU-VM hosts have ~100; CI boxes may have 1). The
  // lane count defaults from the core count; DDSTORE_TCP_LANES overrides
  // (DDSTORE_CONNS_PER_PEER is the pre-lane name of the same knob, kept
  // as a fallback alias so existing deployments keep their setting).
  unsigned hw = std::thread::hardware_concurrency();
  hw_cores_ = hw ? hw : 1;
  // Control-plane retry knobs, resolved once (control ops run under
  // PingConn::mu; no getenv per round trip).
  control_timeout_ms_ = ControlTimeoutMsFromEnv();
  control_retry_max_ = ControlRetryMaxFromEnv();
  long nconn = EnvLong(
      "DDSTORE_TCP_LANES",
      EnvLong("DDSTORE_CONNS_PER_PEER", hw >= 8 ? 4 : (hw >= 4 ? 2 : 1)));
  if (nconn > 64) nconn = 64;
  {
    // Lane autotuners (one per traffic class): measurement levels
    // 1, 2, 4, ... pool size. A 1-lane pool (or
    // DDSTORE_TCP_LANES_AUTOTUNE=0) parks immediately at the pool size
    // — zero measurement overhead, and the 1-lane path stays byte- and
    // error-code-identical to the pre-lane tree.
    const char* at = ::getenv("DDSTORE_TCP_LANES_AUTOTUNE");
    const bool autotune = !at || std::strtol(at, nullptr, 10) != 0;
    scatter_lanes_.name = "scatter";
    scatter_lanes_.cls = 1;
    for (LaneTuner* t : {&bulk_lanes_, &scatter_lanes_}) {
      t->autotune = autotune;
      for (int l = 1; l < static_cast<int>(nconn); l *= 2)
        t->levels.push_back(l);
      t->levels.push_back(static_cast<int>(nconn));
      t->stats.assign(t->levels.size(), WarmStat{});
      if (!autotune || nconn <= 1) {
        t->parked = true;
        t->active = static_cast<int>(nconn);
      }
    }
  }
  peers_.resize(world_);
  ping_conns_.resize(world_);
  for (int i = 0; i < world_; ++i) {
    peers_[i] = std::make_unique<Peer>();
    ping_conns_[i] = std::make_unique<PingConn>();
    ping_conns_[i]->target = i;
    for (long c = 0; c < nconn; ++c) {
      auto conn = std::make_unique<Conn>();
      conn->idx = static_cast<int>(c);
      peers_[i]->conns.push_back(std::move(conn));
    }
  }
  // C++-only users can set DDSTORE_IFACES (comma-separated local
  // addresses) directly; the Python layer resolves interface names and
  // calls SetLocalIfaces with addresses instead.
  if (const char* env = ::getenv("DDSTORE_IFACES"))
    local_addrs_ = SplitCsv(env);

  // CMA fast path on by default; a failed segment creation (no /dev/shm)
  // just means no fast path, never an error. Not EnvLong: it treats 0 as
  // "unset" and would make DDSTORE_CMA=0 a no-op.
  const char* cma_env = ::getenv("DDSTORE_CMA");
  if (!cma_env || std::strtol(cma_env, nullptr, 10) != 0) {
    cma_reg_ = std::make_unique<CmaRegistry>();
    if (!cma_reg_->ok()) cma_reg_.reset();
  }
}

TcpTransport::~TcpTransport() {
  StopServing();
  for (auto& p : peers_) {
    if (!p) continue;
    for (auto& c : p->conns)
      if (c->fd >= 0) ::close(c->fd);
  }
  for (auto& pc : ping_conns_)
    if (pc && pc->fd >= 0) ::close(pc->fd);
}

void TcpTransport::StopServing() {
  if (stopping_.exchange(true)) return;  // the store's teardown came first
  if (listen_fd_ >= 0) {
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
  }
  if (uds_listen_fd_ >= 0) {
    // shutdown() on a LISTENING unix socket is ENOTCONN (Linux and
    // sandboxed kernels alike) and close() does not wake a thread
    // already blocked in accept(); a throwaway self-connect does. The
    // woken loop sees stopping_ and exits; the dummy connection's
    // handler thread sees EOF and exits with the others below.
    int wfd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (wfd >= 0) {
      sockaddr_un ua;
      const socklen_t ulen = UdsAddr(server_port_, &ua);
      ::connect(wfd, reinterpret_cast<sockaddr*>(&ua), ulen);
      ::close(wfd);
    }
  }
  // Join the accept loops FIRST so conn_fds_ can no longer grow; only
  // then shut the (now-stable) set of connection fds down and join
  // handlers — otherwise a connection accepted mid-teardown would miss
  // its shutdown and its handler thread would block join() forever in
  // recv.
  if (accept_thread_.joinable()) accept_thread_.join();
  if (uds_accept_thread_.joinable()) uds_accept_thread_.join();
  if (uds_listen_fd_ >= 0) ::close(uds_listen_fd_);
  {
    std::lock_guard<std::mutex> lock(conns_mu_);
    for (int fd : conn_fds_) ::shutdown(fd, SHUT_RDWR);
    for (auto& t : conn_threads_)
      if (t.joinable()) t.join();
    for (int fd : conn_fds_) ::close(fd);
    conn_threads_.clear();
    conn_fds_.clear();
  }
}

int TcpTransport::SetPeers(const std::vector<std::string>& hosts,
                           const std::vector<int>& ports) {
  if (static_cast<int>(hosts.size()) != world_ ||
      static_cast<int>(ports.size()) != world_)
    return kErrInvalidArg;
  for (int i = 0; i < world_; ++i) {
    std::vector<std::string> hlist = SplitCsv(hosts[i]);
    if (hlist.empty()) return kErrInvalidArg;
    Peer& p = *peers_[i];
    {
      // Endpoint writes hold EVERY conn mutex — the same discipline
      // UpdatePeer uses (EnsureConnected reads hosts/port under its
      // own lane's mutex). Uncontended at bootstrap; ddlint-enforced.
      std::vector<std::unique_lock<std::mutex>> locks;
      locks.reserve(p.conns.size());
      for (auto& c : p.conns) locks.emplace_back(c->mu);
      p.hosts = hlist;
      p.port = ports[i];
    }
    PingConn& pc = *ping_conns_[i];
    std::lock_guard<std::mutex> lock(pc.mu);
    pc.hosts = std::move(hlist);
    pc.next_host = 0;
    pc.port = ports[i];
  }
  return kOk;
}

int64_t TcpTransport::barrier_seq() {
  std::lock_guard<std::mutex> lock(barrier_mu_);
  return barrier_seq_;
}

void TcpTransport::SetBarrierSeq(int64_t seq) {
  std::lock_guard<std::mutex> lock(barrier_mu_);
  if (seq > barrier_seq_) barrier_seq_ = seq;
  // Also retire everything at or below: any notify a peer sent for an
  // older collective belongs to a barrier this rank never ran.
  if (seq > retired_seq_) retired_seq_ = seq;
}

int TcpTransport::UpdatePeer(int target, const std::string& host_csv,
                             int port) {
  if (target < 0 || target >= world_ || target == rank_)
    return kErrInvalidArg;
  std::vector<std::string> hosts = SplitCsv(host_csv);
  if (hosts.empty()) return kErrInvalidArg;
  Peer& p = *peers_[target];
  {
    // Hold EVERY conn mutex while swapping the endpoint: EnsureConnected
    // reads p.hosts/p.port under its conn's mutex, so this excludes all
    // concurrent users (an in-flight read blocked on the dead fd holds
    // its mutex only until its bounded timeout fires).
    std::vector<std::unique_lock<std::mutex>> locks;
    locks.reserve(p.conns.size());
    for (auto& c : p.conns) locks.emplace_back(c->mu);
    for (auto& c : p.conns) {
      if (c->fd >= 0) {
        ::close(c->fd);
        c->fd = -1;
      }
      c->uds_tried = false;  // the replacement may offer the Unix lane
    }
    p.hosts = hosts;  // keep the local: the PingConn update below must
    p.port = port;    // not re-read p.* outside the conn mutexes
    p.instance.store(0);  // the replacement is met afresh
  }
  {
    // The replacement is a different process: its CMA mapping table and
    // pid are new, so force a fresh probe on the next read. The old
    // CmaPeer is RETIRED, not destroyed — a pool thread may still be
    // inside TryReadV on its raw pointer (those reads target the dead
    // pid and fail fast); it is freed at transport teardown.
    std::lock_guard<std::mutex> lock(p.cma_mu);
    p.cma_state = 0;
    ++p.cma_gen;  // invalidates any probe in flight (see EnsureCmaPeer)
    if (p.cma) p.cma_retired.push_back(std::move(p.cma));
  }
  {
    // The adaptive preferences were learned against the OLD peer set
    // (and possibly the old fast-path generation — e.g. pvm-readv-era
    // scatter numbers after the replacement publishes shm-mapped
    // shards). Zeroing the EWMAs forces both classes to re-measure
    // CMA and TCP from scratch instead of parking on a stale verdict
    // that the every-16th probe would need many windows to overturn.
    std::lock_guard<std::mutex> lock(route_mu_);
    for (RouteClass* rc : {&bulk_route_, &scatter_route_}) {
      rc->cma.Reset();
      rc->tcp.Reset();
      rc->cold_skips = 0;
      rc->discard_probe = false;
      // Re-measurement from scratch includes the one-shot calibration:
      // leaving it latched would route the fresh estimates through the
      // hysteresis band only, re-introducing the parked-inside-the-band
      // cold start for every post-replacement lifetime.
      rc->calibrated = false;
    }
  }
  {
    // Same story for the lane parks: they were measured against the
    // old peer set. Re-open both tuners so the replacement lifetime
    // re-measures (no-op when autotune is off or the pool is 1 lane).
    std::lock_guard<std::mutex> lock(lane_mu_);
    for (LaneTuner* t : {&bulk_lanes_, &scatter_lanes_}) {
      if (t->autotune && t->levels.back() > 1) {
        t->parked = false;
        t->level = 0;
        t->cold_skips = 0;
        t->samples = 0;
        for (WarmStat& s : t->stats) s.Reset();
      }
    }
  }
  // Planner pins were computed against the old peer set too; release
  // them so the adaptive tuners own the knobs until the scheduler's
  // peer-change replan re-applies a fresh plan.
  for (std::atomic<int>& p : route_pin_) p.store(-1);
  for (std::atomic<int>& p : lane_pin_) p.store(-1);
  // The heartbeat's dedicated connection belonged to the dead process;
  // the next ping redials the replacement at its endpoint.
  {
    PingConn& pc = *ping_conns_[target];
    std::lock_guard<std::mutex> lock(pc.mu);
    if (pc.fd >= 0) {
      ::close(pc.fd);
      pc.fd = -1;
    }
    pc.hosts = std::move(hosts);
    pc.next_host = 0;
    pc.port = port;
  }
  return kOk;
}

void TcpTransport::AcceptLoop(int lfd, bool is_tcp) {
  while (!stopping_.load()) {
    sockaddr_storage cli;
    socklen_t len = sizeof(cli);
    int fd = ::accept(lfd, reinterpret_cast<sockaddr*>(&cli), &len);
    if (fd < 0) {
      if (stopping_.load()) return;
      if (errno == EINTR) continue;
      return;
    }
    if (is_tcp) SetNoDelay(fd);
    // The serving thread streams responses out of shard memory under the
    // store's shared lock; a stalled client must not hold that lock
    // forever. Mirrors the client-side SO_RCVTIMEO bound.
    timeval tv;
    tv.tv_sec = EnvLong("DDSTORE_READ_TIMEOUT_S", 300);
    tv.tv_usec = 0;
    ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    std::lock_guard<std::mutex> lock(conns_mu_);
    conn_fds_.push_back(fd);
    conn_threads_.emplace_back([this, fd] { HandleConnection(fd); });
  }
}

void TcpTransport::HandleConnection(int fd) {
  std::string name;
  std::vector<int64_t> oplist;
  std::vector<iovec> iovs;
  std::vector<char> pack;  // small-op staging (see kPackBytes)
  ReqReader rd(fd);        // request side only; responses stay unbuffered
  // Responses stream out of shard memory under the store's SHARED lock;
  // this bounds how long one frame may pin it (total, not per-syscall —
  // a trickle-draining client must not stall exclusive-lock writers
  // like add/update/spill past the documented timeout).
  const double send_budget_s =
      static_cast<double>(EnvLong("DDSTORE_READ_TIMEOUT_S", 300));
  auto send_deadline = [send_budget_s] {
    timespec ts;
    ::clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9 + send_budget_s;
  };
  while (!stopping_.load()) {
    WireReq req;
    if (rd.Read(&req, sizeof(req)) != 0) return;
    if (req.magic != kMagic || req.name_len > 4096) return;
    name.resize(req.name_len);
    if (req.name_len && rd.Read(&name[0], req.name_len) != 0) return;

    // Deterministic fault injection (DDSTORE_FAULT_SPEC), data reads
    // only: barrier/CmaInfo frames stay clean — the control plane has
    // no retry story, and chaos tests target the read paths. One draw
    // per request frame, so a single-threaded request sequence maps to
    // one reproducible fault schedule.
    uint64_t corrupt_h = 0;  // nonzero = corrupt THIS response's payload
    int corrupt_n = 0;
    if ((req.op == kOpRead || req.op == kOpReadVec)) {
      FaultInjector& fi = FaultInjector::Get();
      if (fi.enabled()) {
        const FaultDecision fdec = fi.Draw(rank_);
        if (fdec.kind == FaultKind::kCorrupt) {
          // Served below through a scratch copy — shard memory itself
          // is NEVER touched (the corruption is on the wire, which is
          // exactly what checksum verification must catch; the store's
          // bytes stay good so a retry/replica read can repair).
          corrupt_h = fdec.h | 1;
          corrupt_n = fdec.param_ms;
        }
        if (fdec.kind == FaultKind::kReset) {
          // Drop the connection before responding: the client's recv
          // sees EOF/ECONNRESET immediately (shutdown, not just return
          // — a merely-abandoned fd would park the client on its full
          // read timeout instead of a fast reset).
          ::shutdown(fd, SHUT_RDWR);
          return;
        }
        if (fdec.kind == FaultKind::kTrunc) {
          // Truncated response frame: half a header, then hard-close.
          WireResp junk{kOk, 0, 0};
          FullSend(fd, &junk, sizeof(junk) / 2);
          ::shutdown(fd, SHUT_RDWR);
          return;
        }
        if (fdec.kind == FaultKind::kDelay ||
            fdec.kind == FaultKind::kStall) {
          // Delay serves late (latency chaos); stall (default 2 s)
          // is meant to outlive a test's DDSTORE_READ_TIMEOUT_S so the
          // client times out, resets the lane, and retries. Sliced
          // sleep: teardown must not wait out a stall.
          FaultSleepMs(fdec.param_ms, &stopping_);
        }
      }
    }

    // Control-plane injector arm (ctrl-reset/ctrl-delay/ctrl-stall):
    // the request/response CONTROL ops only. kOpPing stays clean — the
    // detector's verdict schedule must not depend on chaos config —
    // and kOpBarrier notifies are one-way frames with no retry story
    // (the barrier's chaos vehicle is the detector abort, not a lost
    // notify). Draws come from the injector's SEPARATE ctrl counter
    // domain, so the data-plane schedules above are bit-identical with
    // this arm present or absent.
    if (req.op == kOpVarSeq || req.op == kOpRowSums ||
        req.op == kOpSnapPin || req.op == kOpSnapUnpin ||
        req.op == kOpMetrics || req.op == kOpAttach ||
        req.op == kOpDetach || req.op == kOpLease) {
      FaultInjector& fi = FaultInjector::Get();
      if (fi.enabled()) {
        const FaultDecision fdec = fi.DrawCtrl(rank_);
        if (fdec.kind == FaultKind::kReset ||
            fdec.kind == FaultKind::kConnDrop) {
          // Drop the control connection pre-response: the client's
          // ControlRoundTrip fails its recv, closes, and its bounded
          // control-retry loop redials. ctrl-conndrop shares the
          // mechanics but is a separately armable arm targeting
          // gateway/control sessions mid-flight.
          ::shutdown(fd, SHUT_RDWR);
          return;
        }
        if (fdec.kind == FaultKind::kDelay ||
            fdec.kind == FaultKind::kStall)
          // Stall (default 2 s) is meant to outlive the client's
          // DDSTORE_CONTROL_TIMEOUT_MS so its recv times out and the
          // retry redials; delay just serves late. Sliced sleep:
          // teardown must not wait out a stall.
          FaultSleepMs(fdec.param_ms, &stopping_);
      }
    }

    if (req.op == kOpBarrier) {
      // One-way: no response. An acked design deadlocks at teardown — a
      // rank that passes the barrier may close before acking, failing the
      // late peer's notify loop midway so the remaining peers never get
      // notified and wait out the full timeout. The dissemination round
      // rides in req.offset.
      {
        std::lock_guard<std::mutex> lock(barrier_mu_);
        // req.tag carries the sender's collective sequence number. Drop
        // notifies for retired seqs: recreating an erased entry would
        // leak it forever (seqs are never reused).
        if (req.tag > retired_seq_) {
          int round = static_cast<int>(req.offset);
          ++barrier_arrived_[{req.tag, round}];
          if (DebugOn())
            std::fprintf(stderr, "[dds r%d] barrier notify from r%d "
                         "seq=%lld round=%d\n", rank_, req.src,
                         static_cast<long long>(req.tag), round);
        }
      }
      barrier_cv_.notify_all();
      continue;
    }
    if (req.op == kOpHello) {
      WireResp resp{kOk, 0, static_cast<int64_t>(instance_id_)};
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op == kOpPing) {
      // Control-plane liveness probe: a bare ok. Served on this
      // connection's own thread, so a busy data lane never delays it;
      // no fault-injector draw (the gate above lists data ops only).
      WireResp resp{kOk, 0, 0};
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op == kOpVarSeq) {
      // Shard content-version query (the mirror-refresh gate):
      // resp.nbytes carries the update_seq, -1 when unknown.
      WireResp resp{kOk, 0, store_ ? store_->UpdateSeqOf(name) : -1};
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op == kOpRowSums) {
      // Integrity sum serve: req.offset = first owner-local row,
      // req.nbytes = count; payload = [int64 seq][count x uint64].
      // Control plane like kOpPing/kOpVarSeq — deliberately ABOVE the
      // fault gate's op list, so verification traffic never consumes
      // data-path draws.
      constexpr int64_t kMaxSumRows = 1 << 20;
      WireResp resp{kErrNotFound, 0, 0};
      std::vector<uint64_t> sums;
      int64_t seq = -1;
      if (store_ && req.offset >= 0 && req.nbytes >= 0 &&
          req.nbytes <= kMaxSumRows) {
        sums.resize(static_cast<size_t>(req.nbytes));
        resp.status = store_->RowSums(name, req.offset, req.nbytes,
                                      sums.data(), &seq);
      }
      if (resp.status != kOk) {
        resp.nbytes = 0;
        if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
        continue;
      }
      resp.nbytes = 8 + static_cast<int64_t>(sums.size()) * 8;
      iovec iov[3];
      iov[0] = iovec{&resp, sizeof(resp)};
      iov[1] = iovec{&seq, sizeof(seq)};
      iov[2] = iovec{sums.data(), sums.size() * 8};
      if (SendIov(fd, iov, 3, send_deadline()) != 0) return;
      continue;
    }
    if (req.op == kOpMetrics) {
      // ddmetrics pull: serialize this store's live histogram cells.
      // Control plane like kOpRowSums — above the data-path fault
      // gate, bounded by the client's control-retry ladder.
      WireResp resp{kErrNotFound, 0, 0};
      std::string blob;
      if (store_) {
        const int64_t cap = store_->MetricsSnapshot(nullptr, 0);
        blob.resize(static_cast<size_t>(cap));
        const int64_t nb =
            store_->MetricsSnapshot(blob.empty() ? nullptr : &blob[0],
                                    cap);
        blob.resize(nb > 0 ? static_cast<size_t>(nb) : 0);
        resp.status = kOk;
      }
      if (resp.status != kOk) {
        if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
        continue;
      }
      resp.nbytes = static_cast<int64_t>(blob.size());
      iovec iov[2];
      iov[0] = iovec{&resp, sizeof(resp)};
      iov[1] = iovec{blob.empty() ? nullptr : &blob[0], blob.size()};
      if (SendIov(fd, iov, blob.empty() ? 1 : 2, send_deadline()) != 0)
        return;
      continue;
    }
    if (req.op == kOpSnapPin || req.op == kOpSnapUnpin) {
      // Snapshot-epoch pin/release (req.tag = snapshot id, name = the
      // acquiring tenant label). Owner-side registry mutation; the
      // response is just the ack the acquirer's all-or-nothing
      // contract needs.
      int rc = kErrNotFound;
      if (store_)
        rc = req.op == kOpSnapPin ? store_->PinSnapshot(req.tag, name)
                                  : store_->UnpinSnapshot(req.tag);
      WireResp resp{rc, 0, 0};
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op == kOpAttach || req.op == kOpDetach ||
        req.op == kOpLease) {
      // Serving-gateway session control. Attach mints the session on
      // THIS rank's store (name = tenant, tag != 0 pins a snapshot,
      // offset = quota bytes) and returns the token in resp.nbytes;
      // renew/detach address an existing lease by token (tag). These
      // handlers only touch the gateway lease table and the registry
      // — nothing slow runs while the remote reader waits.
      int rc = kErrNotFound;
      int64_t token = 0;
      if (store_) {
        if (req.op == kOpAttach) {
          const int64_t t =
              store_->GatewayAttach(name, req.tag != 0 ? 1 : 0,
                                    req.offset);
          if (t < 0) {
            rc = static_cast<int>(t);
          } else {
            rc = kOk;
            token = t;
          }
        } else if (req.op == kOpLease) {
          rc = store_->GatewayRenew(req.tag);
        } else {
          rc = store_->GatewayDetach(req.tag);
        }
      }
      WireResp resp{rc, 0, token};
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op == kOpCmaInfo) {
      // Same-host discovery: "<pid> <starttime> <host-token>
      // <segment-name|->". The token (boot_id + pid-namespace) gates
      // whether the caller even attempts process_vm_readv; the attempt
      // itself is authoritative. starttime lets the caller reject a
      // recycled pid (see CmaPeer::Open). A peer asking for our info is
      // about to read us — this is where the ptrace relaxation engages.
      static const std::string token = CmaHostToken();
      if (cma_reg_) cma_reg_->EnableReads();
      char payload[256];
      int len = std::snprintf(
          payload, sizeof(payload), "%ld %llu %s %s",
          static_cast<long>(::getpid()),
          static_cast<unsigned long long>(ProcStartTime(::getpid())),
          token.c_str(),
          cma_reg_ ? cma_reg_->shm_name().c_str() : "-");
      WireResp resp{kOk, 0, len};
      if (SendVec(fd, &resp, sizeof(resp), payload,
                  static_cast<size_t>(len)) != 0)
        return;
      continue;
    }
    if (req.op == kOpReadVec) {
      // Vectored read: req.offset = op count, req.nbytes = total payload,
      // followed by count x (offset, nbytes) int64 pairs. Zero
      // intermediate copy: the response header + every op's slice of the
      // shard go out in one vectored send STRAIGHT from shard memory,
      // under the store's shared lock (a concurrent FreeVar/Rebind must
      // not pull the shard out mid-send; SO_SNDTIMEO bounds how long a
      // stalled client can pin the lock).
      const int64_t nops = req.offset;
      if (nops <= 0 || nops > kVecMaxOps || req.nbytes < 0 ||
          req.nbytes > kVecMaxBytes)
        return;
      oplist.resize(static_cast<size_t>(nops) * 2);
      if (rd.Read(oplist.data(), static_cast<size_t>(nops) * 16) != 0)
        return;
      WireResp resp{kOk, 0, 0};
      int64_t total = 0;
      bool bad = false;
      for (int64_t i = 0; i < nops; ++i) {
        const int64_t nb = oplist[2 * i + 1];
        // `nb > kVecMaxBytes - total` (with total <= kVecMaxBytes as
        // invariant), NOT `total + nb > cap`: the latter wraps on a
        // crafted near-INT64_MAX nbytes and would pass validation.
        if (nb < 0 || nb > kVecMaxBytes - total) {
          bad = true;
          break;
        }
        total += nb;
      }
      if (!store_) {
        resp.status = kErrNotFound;
      } else if (bad || total != req.nbytes) {
        resp.status = kErrInvalidArg;
      } else {
        // Serving leg recorded under the REQUESTER's span (frame tag):
        // the one-sided read's other half finally holds its side of
        // the story. req.tag is 0 when the requester traced nothing.
        if (req.tag != 0)
          trace::Emit(trace::kServeBegin,
                      static_cast<uint64_t>(req.tag), rank_, req.src,
                      nops, total);
        bool conn_dead = false;
        int rc = store_->WithShard(
            name, [&](const char* base, int64_t sb) {
              int64_t packed = 0;
              for (int64_t i = 0; i < nops; ++i) {
                const int64_t off = oplist[2 * i], nb = oplist[2 * i + 1];
                if (off < 0 || off > sb || nb > sb - off)
                  return kErrOutOfRange;
                if (nb < kPackBytes) packed += nb;
              }
              resp.nbytes = total;
              if (corrupt_h) {
                // Injected corruption: the WHOLE payload stages through
                // one scratch copy (never shard memory) with
                // deterministic bit-flips applied, then ships as a
                // well-formed frame — no transport error fires, only
                // checksum verification can notice.
                std::vector<char> cbuf(static_cast<size_t>(total));
                int64_t cpos = 0;
                for (int64_t i = 0; i < nops; ++i) {
                  const int64_t off = oplist[2 * i];
                  const int64_t nb = oplist[2 * i + 1];
                  if (nb <= 0) continue;
                  std::memcpy(cbuf.data() + cpos, base + off,
                              static_cast<size_t>(nb));
                  cpos += nb;
                }
                CorruptBytes(cbuf.data(), total, corrupt_h, corrupt_n);
                iovec civ[2];
                civ[0] = iovec{&resp, sizeof(resp)};
                civ[1] = iovec{cbuf.data(), static_cast<size_t>(total)};
                if (SendIov(fd, civ, 2, send_deadline()) != 0)
                  conn_dead = true;
                return kOk;
              }
              // Hybrid framing: small ops memcpy into `pack` and CONSECUTIVE
              // packed ops merge into one iovec (the staging area is filled
              // sequentially), big ops go out zero-copy straight from shard
              // memory — a scatter frame of 1000 rows becomes ~1 iovec + 1
              // memcpy pass instead of a 1000-entry sendmsg walk.
              if (static_cast<int64_t>(pack.size()) < packed)
                pack.resize(static_cast<size_t>(packed));
              iovs.clear();
              iovs.push_back(iovec{&resp, sizeof(resp)});
              char* sp = pack.data();
              bool prev_packed = false;
              for (int64_t i = 0; i < nops; ++i) {
                const int64_t off = oplist[2 * i], nb = oplist[2 * i + 1];
                if (nb <= 0) continue;
                const char* src = base + off;
                if (nb < kPackBytes) {
                  std::memcpy(sp, src, static_cast<size_t>(nb));
                  if (prev_packed)
                    iovs.back().iov_len += static_cast<size_t>(nb);
                  else
                    iovs.push_back(iovec{sp, static_cast<size_t>(nb)});
                  sp += nb;
                  prev_packed = true;
                } else {
                  iovs.push_back(iovec{const_cast<char*>(src),
                                       static_cast<size_t>(nb)});
                  prev_packed = false;
                }
              }
              if (SendIov(fd, iovs.data(), static_cast<int>(iovs.size()),
                          send_deadline()) != 0)
                conn_dead = true;
              return kOk;
            });
        if (req.tag != 0)
          trace::Emit(trace::kServeEnd,
                      static_cast<uint64_t>(req.tag), rank_, req.src,
                      conn_dead ? kErrTransport : rc, total);
        if (conn_dead) return;
        if (rc == kOk) {  // header + payload already sent
          // Tenant serve ledger: the op frame's variable name IS the
          // tenant tag (scoped registration makes it so); a no-op
          // first-byte check for unscoped names.
          store_->AccountTenantServe(name, total);
          continue;
        }
        resp.status = rc;         // kErrNotFound / kErrOutOfRange
      }
      resp.nbytes = 0;
      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
      continue;
    }
    if (req.op != kOpRead) return;

    // Scalar read: same zero-copy vectored send, two iovec entries.
    WireResp resp{kOk, 0, 0};
    if (!store_) {
      resp.status = kErrNotFound;
    } else {
      if (req.tag != 0)
        trace::Emit(trace::kServeBegin, static_cast<uint64_t>(req.tag),
                    rank_, req.src, 1, req.nbytes);
      bool conn_dead = false;
      int rc = store_->WithShard(
          name, [&](const char* base, int64_t sb) {
            if (req.offset < 0 || req.nbytes < 0 || req.offset > sb ||
                req.nbytes > sb - req.offset)
              return kErrOutOfRange;
            resp.nbytes = req.nbytes;
            if (corrupt_h && req.nbytes > 0) {
              // Same scratch-copy corruption as the vectored path.
              std::vector<char> cbuf(static_cast<size_t>(req.nbytes));
              std::memcpy(cbuf.data(), base + req.offset,
                          static_cast<size_t>(req.nbytes));
              CorruptBytes(cbuf.data(), req.nbytes, corrupt_h, corrupt_n);
              iovec civ[2];
              civ[0] = iovec{&resp, sizeof(resp)};
              civ[1] = iovec{cbuf.data(), static_cast<size_t>(req.nbytes)};
              if (SendIov(fd, civ, 2, send_deadline()) != 0)
                conn_dead = true;
              return kOk;
            }
            iovec iov[2];
            iov[0] = iovec{&resp, sizeof(resp)};
            iov[1] = iovec{const_cast<char*>(base) + req.offset,
                           static_cast<size_t>(req.nbytes)};
            if (SendIov(fd, iov, 2, send_deadline()) != 0) conn_dead = true;
            return kOk;
          });
      if (req.tag != 0)
        trace::Emit(trace::kServeEnd, static_cast<uint64_t>(req.tag),
                    rank_, req.src,
                    conn_dead ? kErrTransport : rc, req.nbytes);
      if (conn_dead) return;
      if (rc == kOk) {  // header + payload already sent
        store_->AccountTenantServe(name, req.nbytes);
        continue;
      }
      resp.status = rc;
    }
    resp.nbytes = 0;
    if (FullSend(fd, &resp, sizeof(resp)) != 0) return;
  }
}

int TcpTransport::EnsureConnected(Peer& p, Conn& c) {
  if (c.fd >= 0) return kOk;
  if (p.port < 0 || p.hosts.empty()) return kErrTransport;

  // Pool member i talks to the peer's i-th advertised NIC address and
  // binds its local end to our i-th NIC (both round-robin), so striped
  // reads spread over every DCN interface pair instead of one.
  const std::string& host = p.hosts[c.idx % p.hosts.size()];

  // Same-host fast lane: dial the peer's abstract Unix listener before
  // TCP. One attempt, no retry loop — the peer created its listeners
  // before publishing its port to the rendezvous, so a refused Unix
  // connect means the lane is absent on that side (disabled or bind
  // lost), not that the peer is still starting; fall back to TCP, whose
  // own dial has the bounded-retry budget.
  if (!c.uds_tried && UdsEnabled() && LoopbackHost(host)) {
    c.uds_tried = true;
    int ufd = ::socket(AF_UNIX, SOCK_STREAM, 0);
    if (ufd >= 0) {
      SetBufSizes(ufd);
      sockaddr_un ua;
      const socklen_t ulen = UdsAddr(p.port, &ua);
      if (::connect(ufd, reinterpret_cast<sockaddr*>(&ua), ulen) == 0) {
        timeval utv;
        utv.tv_sec = EnvLong("DDSTORE_READ_TIMEOUT_S", 300);
        utv.tv_usec = 0;
        ::setsockopt(ufd, SOL_SOCKET, SO_RCVTIMEO, &utv, sizeof(utv));
        if (!Introduce(p, ufd)) {
          ::close(ufd);
          return kErrTransport;
        }
        c.fd = ufd;
        dials_.fetch_add(1, std::memory_order_relaxed);
        uds_conns_.fetch_add(1, std::memory_order_relaxed);
        trace::Ev(trace::kLaneDial, rank_, c.idx, 1, 0);
        return kOk;
      }
      ::close(ufd);
    }
  }

  addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  char portstr[16];
  std::snprintf(portstr, sizeof(portstr), "%d", p.port);
  if (::getaddrinfo(host.c_str(), portstr, &hints, &res) != 0 || !res)
    return kErrTransport;

  int fd = -1;
  // Peers start asynchronously; retry connect within a bounded budget
  // (failure detection: a peer that never comes up surfaces as
  // kErrTransport, not an indefinite spin — the reference's only retry is
  // fi_read on -EAGAIN, common.cxx:332-343, with no bound at all).
  const auto budget = std::chrono::seconds(
      EnvLong("DDSTORE_CONNECT_TIMEOUT_S", 30));
  // Wall-clock budget (not sleep-count): a blackholed peer makes each
  // ::connect itself block for the kernel SYN timeout, which must count.
  const auto deadline = std::chrono::steady_clock::now() + budget;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    SetBufSizes(fd);  // must precede connect() for window scaling
    if (!local_addrs_.empty()) {
      const std::string& src =
          local_addrs_[static_cast<size_t>(c.idx) % local_addrs_.size()];
      sockaddr_in la;
      std::memset(&la, 0, sizeof(la));
      la.sin_family = AF_INET;
      if (::inet_pton(AF_INET, src.c_str(), &la.sin_addr) == 1) {
        // Best effort: an unbindable source address (NIC down, bad
        // config) falls back to the kernel's default route rather than
        // failing the read path.
        if (::bind(fd, reinterpret_cast<sockaddr*>(&la), sizeof(la)) != 0 &&
            DebugOn())
          std::fprintf(stderr, "[dds r%d] bind to iface %s failed: %s\n",
                       rank_, src.c_str(), std::strerror(errno));
      } else if (DebugOn()) {
        std::fprintf(stderr, "[dds r%d] bad DDSTORE_IFACES entry %s\n",
                     rank_, src.c_str());
      }
    }
    while (::connect(fd, ai->ai_addr, ai->ai_addrlen) < 0) {
      if ((errno == ECONNREFUSED || errno == ETIMEDOUT) &&
          std::chrono::steady_clock::now() < deadline &&
          !stopping_.load()) {
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
        continue;
      }
      ::close(fd);
      fd = -1;
      break;
    }
    if (fd >= 0) break;
  }
  ::freeaddrinfo(res);
  if (fd < 0) return kErrTransport;
  SetNoDelay(fd);
  // A peer that is alive but wedged (or died without RST) must not hang
  // readers forever: bound every response wait. FullRecv treats the
  // EAGAIN timeout as failure, ReadV resets the connection and surfaces
  // kErrTransport to the caller.
  timeval tv;
  tv.tv_sec = EnvLong("DDSTORE_READ_TIMEOUT_S", 300);
  tv.tv_usec = 0;
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (!Introduce(p, fd)) {
    ::close(fd);
    return kErrTransport;
  }
  c.fd = fd;
  dials_.fetch_add(1, std::memory_order_relaxed);
  trace::Ev(trace::kLaneDial, rank_, c.idx, 0, 0);
  return kOk;
}

uint64_t TcpTransport::NewInstanceId() {
  std::random_device rd;
  uint64_t id = (static_cast<uint64_t>(rd()) << 32) ^ rd() ^
                static_cast<uint64_t>(
                    std::chrono::steady_clock::now().time_since_epoch()
                        .count());
  return id != 0 ? id : 1;
}

bool TcpTransport::Introduce(Peer& p, int fd) {
  WireReq req{kMagic, kOpHello, rank_, 0, 0, 0, 0};
  WireResp resp;
  if (FullSend(fd, &req, sizeof(req)) != 0 ||
      FullRecv(fd, &resp, sizeof(resp)) != 0 || resp.status != kOk)
    return false;
  const uint64_t got = static_cast<uint64_t>(resp.nbytes);
  uint64_t met = 0;
  if (p.instance.compare_exchange_strong(met, got)) return true;
  if (met != got && DebugOn())
    std::fprintf(stderr, "[dds r%d] a connection to a peer's port reached "
                 "another store instance; refused\n", rank_);
  return met == got;
}

int TcpTransport::Read(int target, const std::string& name, int64_t offset,
                       int64_t nbytes, void* dst) {
  ReadOp op{offset, nbytes, dst};
  return ReadV(target, name, &op, 1);
}

namespace {
// Bounded dial for the heartbeat control plane: non-blocking connect +
// poll, so a dead or blackholed peer costs at most `timeout_ms` — never
// the kernel SYN timeout (the data path's blocking dial is bounded by
// DDSTORE_CONNECT_TIMEOUT_S, far too long for a sub-second detector).
int DialWithTimeout(const sockaddr* addr, socklen_t alen,
                    long timeout_ms) {
  int fd = ::socket(addr->sa_family, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  const int flags = ::fcntl(fd, F_GETFL, 0);
  ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
  if (::connect(fd, addr, alen) != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return -1;
    }
    pollfd p{fd, POLLOUT, 0};
    if (::poll(&p, 1, static_cast<int>(timeout_ms)) <= 0) {
      ::close(fd);
      return -1;
    }
    int err = 0;
    socklen_t el = sizeof(err);
    if (::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &el) != 0 ||
        err != 0) {
      ::close(fd);
      return -1;
    }
  }
  ::fcntl(fd, F_SETFL, flags);
  return fd;
}
}  // namespace

int TcpTransport::EnsureControlConn(PingConn& pc, long timeout_ms) {
  if (pc.fd >= 0) return pc.fd;
  // Rotate across every advertised NIC address: a multi-homed peer
  // whose first NIC is down must not read as dead while its data lanes
  // (round-robin over the same list) still work.
  for (size_t attempt = 0; attempt < pc.hosts.size(); ++attempt) {
    const std::string& host = pc.hosts[pc.next_host % pc.hosts.size()];
    addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    char portstr[16];
    std::snprintf(portstr, sizeof(portstr), "%d", pc.port);
    int fd = -1;
    if (::getaddrinfo(host.c_str(), portstr, &hints, &res) == 0 && res) {
      for (addrinfo* ai = res; ai && fd < 0; ai = ai->ai_next)
        fd = DialWithTimeout(ai->ai_addr, ai->ai_addrlen, timeout_ms);
      ::freeaddrinfo(res);
    }
    if (fd >= 0) {
      SetNoDelay(fd);
      timeval tv;
      tv.tv_sec = timeout_ms / 1000;
      tv.tv_usec = (timeout_ms % 1000) * 1000;
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      if (!Introduce(*peers_[pc.target], fd)) {
        ::close(fd);
        return -1;
      }
      pc.fd = fd;
      return fd;
    }
    ++pc.next_host;  // next probe tries the peer's next address
  }
  return -1;
}

bool TcpTransport::ControlRoundTrip(PingConn& pc, uint32_t op,
                                    const std::string& name,
                                    long timeout_ms, void* resp,
                                    int64_t tag, int64_t offset,
                                    int64_t nbytes, std::string* payload,
                                    int64_t payload_cap) {
  auto fail = [&]() {
    if (pc.fd >= 0) {
      ::close(pc.fd);
      pc.fd = -1;
    }
    return false;
  };
  if (EnsureControlConn(pc, timeout_ms) < 0) return false;
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  ::setsockopt(pc.fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(pc.fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  WireReq req{kMagic, op, rank_,
              static_cast<uint32_t>(name.size()), offset, nbytes, tag};
  if (FullSend(pc.fd, &req, sizeof(req)) != 0) return fail();
  if (!name.empty() &&
      FullSend(pc.fd, name.data(), name.size()) != 0)
    return fail();
  if (FullRecv(pc.fd, resp, sizeof(WireResp)) != 0) return fail();
  WireResp* r = static_cast<WireResp*>(resp);
  if (r->status != kOk) {
    // A WELL-FORMED error response (kErrNotFound from a peer whose
    // integrity is off, a real snapshot-pin error) leaves the stream
    // in sync: keep the connection — callers read resp->status. Only
    // an error frame that ALSO announces a body is a protocol fault.
    if (payload && r->nbytes != 0) return fail();
    return true;
  }
  if (payload) {
    // Response body announced in resp.nbytes; an oversized/negative
    // announcement is a protocol fault and the connection resets (a
    // partially drained body would desynchronize the next round trip).
    if (r->nbytes < 0 || r->nbytes > payload_cap) return fail();
    payload->resize(static_cast<size_t>(r->nbytes));
    if (r->nbytes > 0 &&
        FullRecv(pc.fd, &(*payload)[0], payload->size()) != 0)
      return fail();
  }
  return true;
}

std::function<bool(int)> TcpTransport::SuspectSnapshot() {
  std::lock_guard<std::mutex> lock(oracle_mu_);
  return suspect_oracle_;
}

bool TcpTransport::Ping(int target, long timeout_ms) {
  if (target < 0 || target >= world_ || target == rank_) return true;
  if (timeout_ms < 50) timeout_ms = 50;
  PingConn& pc = *ping_conns_[target];
  // Blocking lock: a concurrent control op holds this for at most ONE
  // attempt's bounded round trip (the control-retry loops release it
  // across their backoff sleeps precisely so pings queue behind one
  // round trip, never a whole ladder), and a contended probe must WAIT
  // and then truly measure — returning "alive" for a probe that never
  // ran would reset the failure streak and stretch detection past the
  // HEARTBEAT_MS * SUSPECT_N bound the tests assert.
  std::lock_guard<std::mutex> lock(pc.mu);
  // Endpoints not exchanged yet: liveness is undecidable, and the
  // detector must not raise suspects during bootstrap.
  if (pc.port < 0 || pc.hosts.empty()) return true;
  WireResp resp;
  return ControlRoundTrip(pc, kOpPing, std::string(), timeout_ms,
                          &resp) &&
         resp.status == kOk;
}

int64_t TcpTransport::ReadVarSeq(int target, const std::string& name) {
  if (target < 0 || target >= world_ || target == rank_) return -1;
  const std::function<bool(int)> suspect = SuspectSnapshot();
  PingConn& pc = *ping_conns_[target];
  WireResp resp;
  // Bounded control retry (the RetryTransientLoop contract scaled to
  // control ops): suspect short-circuit before every attempt, redial +
  // short backoff between attempts. pc.mu is scoped to ONE attempt —
  // a heartbeat ping must never queue behind a whole retry ladder's
  // backoff sleeps, only behind one bounded round trip. The caller's
  // -1 contract ("pull unconditionally") is the safe terminal state.
  for (int att = 0;; ++att) {
    if (suspect && suspect(target)) return -1;
    if (stopping_.load(std::memory_order_relaxed)) return -1;
    bool ok;
    {
      std::lock_guard<std::mutex> lock(pc.mu);
      if (pc.port < 0 || pc.hosts.empty()) return -1;
      ok = ControlRoundTrip(pc, kOpVarSeq, name, control_timeout_ms_,
                            &resp);
    }
    if (ok) break;
    if (att >= control_retry_max_) return -1;
    FaultSleepMs(ControlBackoffMs(att), &stopping_);
  }
  return resp.status == kOk ? resp.nbytes : -1;
}

int TcpTransport::ReadRowSums(int target, const std::string& name,
                              int64_t row0, int64_t count, int64_t* seq,
                              uint64_t* sums) {
  if (target < 0 || target >= world_ || target == rank_ || count < 0 ||
      row0 < 0 || !seq || !sums)
    return kErrInvalidArg;
  const std::function<bool(int)> suspect = SuspectSnapshot();
  PingConn& pc = *ping_conns_[target];
  WireResp resp;
  std::string payload;
  // 5x the base control deadline: a sum fetch carries a BULK payload
  // (up to 512 KiB per 65536-row chunk), not a bare ack — at the
  // 1000 ms default this is exactly the old 5000 ms one-shot window,
  // and a retry restarting the transfer from zero must not be capped
  // tighter than the transfer itself.
  const long sums_timeout_ms = control_timeout_ms_ * 5;
  for (int att = 0;; ++att) {
    // A detector-declared-dead owner classifies as the bounded "peer
    // is gone" signal, without burning the control budget against a
    // corpse; plain exhaustion stays kErrTransport (slow != dead).
    if (suspect && suspect(target)) return kErrPeerLost;
    if (stopping_.load(std::memory_order_relaxed)) return kErrTransport;
    bool ok;
    {
      std::lock_guard<std::mutex> lock(pc.mu);
      if (pc.port < 0 || pc.hosts.empty()) return kErrTransport;
      ok = ControlRoundTrip(pc, kOpRowSums, name, sums_timeout_ms,
                            &resp, /*tag=*/0, /*offset=*/row0,
                            /*nbytes=*/count, &payload,
                            /*payload_cap=*/8 + count * 8);
    }
    if (ok) break;
    if (att >= control_retry_max_) return kErrTransport;
    FaultSleepMs(ControlBackoffMs(att), &stopping_);
  }
  // A peer without integrity enabled answers kErrNotFound in-band —
  // "unverifiable", not a transport fault; the connection stays up.
  if (resp.status != kOk) return resp.status;
  if (static_cast<int64_t>(payload.size()) != 8 + count * 8)
    return kErrTransport;
  std::memcpy(seq, payload.data(), 8);
  std::memcpy(sums, payload.data() + 8,
              static_cast<size_t>(count) * 8);
  return kOk;
}

int64_t TcpTransport::ReadMetrics(int target, void* out, int64_t cap) {
  if (target < 0 || target >= world_ || target == rank_ || !out ||
      cap < 0)
    return kErrInvalidArg;
  const std::function<bool(int)> suspect = SuspectSnapshot();
  PingConn& pc = *ping_conns_[target];
  WireResp resp;
  std::string payload;
  // Bulk-payload control op like ReadRowSums: a full snapshot is up to
  // kMaxCells records (~400 KiB), so each attempt runs at 5x the base
  // control deadline and a transport-failed round trip redials with
  // the bounded ladder.
  const long timeout_ms = control_timeout_ms_ * 5;
  const int64_t worst =
      static_cast<int64_t>(metrics::kMaxCells) *
      static_cast<int64_t>(sizeof(metrics::CellRecord));
  for (int att = 0;; ++att) {
    // A detector-declared-dead peer classifies immediately: the
    // cluster-view caller records the hole and moves on, burning no
    // budget against a corpse.
    if (suspect && suspect(target)) return kErrPeerLost;
    if (stopping_.load(std::memory_order_relaxed)) return kErrTransport;
    bool ok;
    {
      std::lock_guard<std::mutex> lock(pc.mu);
      if (pc.port < 0 || pc.hosts.empty()) return kErrTransport;
      ok = ControlRoundTrip(pc, kOpMetrics, std::string(), timeout_ms,
                            &resp, /*tag=*/0, /*offset=*/0,
                            /*nbytes=*/0, &payload,
                            /*payload_cap=*/worst);
    }
    if (ok) break;
    if (att >= control_retry_max_) return kErrTransport;
    FaultSleepMs(ControlBackoffMs(att), &stopping_);
  }
  if (resp.status != kOk) return resp.status;
  int64_t nb = static_cast<int64_t>(payload.size());
  if (nb > cap) {
    // Deliver what fits, truncated to whole records — the same
    // cap-bounded contract Registry::Snapshot gives a local caller
    // (binding callers size from the shared worst case and never hit
    // this; a tight native cap must not read as a dead peer).
    constexpr int64_t kRec =
        static_cast<int64_t>(sizeof(metrics::CellRecord));
    nb = cap - cap % kRec;
  }
  if (nb > 0) std::memcpy(out, payload.data(), static_cast<size_t>(nb));
  return nb;
}

int TcpTransport::SnapshotControl(int target, int64_t snap_id, bool pin,
                                  const std::string& tenant) {
  if (target < 0 || target >= world_ || target == rank_)
    return kErrInvalidArg;
  const std::function<bool(int)> suspect = SuspectSnapshot();
  PingConn& pc = *ping_conns_[target];
  WireResp resp;
  for (int att = 0;; ++att) {
    // kErrPeerLost (not kErrTransport) for a detector-declared-dead
    // target: SnapshotAcquire's all-or-nothing rollback (partial-pin
    // unwind) engages immediately with the classified signal.
    if (suspect && suspect(target)) return kErrPeerLost;
    if (stopping_.load(std::memory_order_relaxed)) return kErrTransport;
    bool ok;
    {
      std::lock_guard<std::mutex> lock(pc.mu);
      if (pc.port < 0 || pc.hosts.empty()) return kErrTransport;
      ok = ControlRoundTrip(pc, pin ? kOpSnapPin : kOpSnapUnpin,
                            tenant, control_timeout_ms_, &resp,
                            snap_id);
    }
    if (ok) break;
    if (att >= control_retry_max_) return kErrTransport;
    FaultSleepMs(ControlBackoffMs(att), &stopping_);
  }
  return resp.status;
}

int TcpTransport::GatewayControl(int target, int verb,
                                 const std::string& tenant, int64_t arg,
                                 int64_t arg2, int64_t* token_out) {
  if (target < 0 || target >= world_ || target == rank_ || verb < 0 ||
      verb > 2)
    return kErrInvalidArg;
  // Same ladder as SnapshotControl: suspected peers short-circuit,
  // transport failures (including a ctrl-conndrop hard-close) redial
  // within the bounded control-retry budget.
  const std::function<bool(int)> suspect = SuspectSnapshot();
  PingConn& pc = *ping_conns_[target];
  WireResp resp;
  const uint32_t op =
      verb == 0 ? kOpAttach : (verb == 1 ? kOpLease : kOpDetach);
  for (int att = 0;; ++att) {
    if (suspect && suspect(target)) return kErrPeerLost;
    if (stopping_.load(std::memory_order_relaxed)) return kErrTransport;
    bool ok;
    {
      std::lock_guard<std::mutex> lock(pc.mu);
      if (pc.port < 0 || pc.hosts.empty()) return kErrTransport;
      // Attach: tag = with-snapshot flag, offset = quota bytes.
      // Renew/detach: tag = session token.
      ok = ControlRoundTrip(pc, op, tenant, control_timeout_ms_, &resp,
                            arg, verb == 0 ? arg2 : 0);
    }
    if (ok) break;
    if (att >= control_retry_max_) return kErrTransport;
    FaultSleepMs(ControlBackoffMs(att), &stopping_);
  }
  if (resp.status == kOk && token_out) *token_out = resp.nbytes;
  return resp.status;
}

int TcpTransport::SetTenantLaneBudget(const std::string& tenant,
                                      int lanes) {
  std::lock_guard<std::mutex> lock(lane_mu_);
  if (lanes <= 0)
    tenant_lane_budget_.erase(tenant);
  else
    tenant_lane_budget_[tenant].lanes = lanes;
  tenant_budgets_set_.store(!tenant_lane_budget_.empty(),
                            std::memory_order_relaxed);
  return kOk;
}

int TcpTransport::TenantLaneBudget(const std::string& name,
                                   uint64_t* rot,
                                   const std::string& as_tenant) {
  if (!tenant_budgets_set_.load(std::memory_order_relaxed)) return 0;
  // The READING tenant owns the budget: a named tenant streaming the
  // shared default namespace burns its own lanes, not the default
  // tenant's (mirrors the async admission gate's as_tenant rule).
  const std::string tenant =
      as_tenant.empty() ? TenantOfVarName(name) : as_tenant;
  std::lock_guard<std::mutex> lock(lane_mu_);
  auto it = tenant_lane_budget_.find(tenant);
  if (it == tenant_lane_budget_.end()) return 0;
  // Rotate the tenant's lane window one slot per batch: a budget-1
  // tenant camping on pool index 0 forever would turn lane 0 into a
  // hotspot every OTHER tenant's full-width stripes must queue behind
  // — the budget would throttle the tenants it is meant to protect.
  // Time-sharing the window across the pool spreads a budgeted
  // tenant's load uniformly instead.
  if (rot) *rot = it->second.rotor++;
  return it->second.lanes;
}

int TcpTransport::WireRouteLabel() const { return metrics::kRouteTcp; }

int TcpTransport::ReadVOn(Peer& p, Conn& c, const std::string& name,
                          const ReadOp* ops, int64_t n) {
  std::lock_guard<std::mutex> lock(c.mu);
  int rc = EnsureConnected(p, c);
  if (rc != kOk) return rc;

  auto fail = [&]() {
    trace::Ev(trace::kLaneClose, rank_, c.idx, kErrTransport, 0);
    ::close(c.fd);
    c.fd = -1;
    return kErrTransport;
  };

  // Cross-rank span propagation: the requester's active span rides the
  // frame's `tag` field — RESERVED (always 0) on data reads until now,
  // so with tracing off the frames below are byte-identical to the
  // untraced tree (pinned by tests/test_trace.py). The serving rank
  // records its streaming leg under this id (see HandleConnection).
  const int64_t tspan = static_cast<int64_t>(trace::CurrentSpan());

  // Greedy framing: consecutive ops share a vectored frame up to the
  // op-count (IOV_MAX) and byte caps; a lone op — including one bigger
  // than the byte cap — rides the scalar protocol.
  struct Frame {
    int64_t begin, end, bytes, req_bytes;
  };
  std::vector<Frame> frames;
  for (int64_t i = 0; i < n;) {
    int64_t j = i, bytes = 0;
    while (j < n && j - i < kVecMaxOps &&
           bytes + ops[j].nbytes <= (ops[j].nbytes < kPackBytes
                                         ? kScatterFrameBytes
                                         : kVecMaxBytes)) {
      bytes += ops[j].nbytes;
      ++j;
    }
    if (j == i) {  // single op over the byte cap
      bytes = ops[i].nbytes;
      j = i + 1;
    }
    const int64_t req_bytes = static_cast<int64_t>(sizeof(WireReq)) +
                              static_cast<int64_t>(name.size()) +
                              (j - i > 1 ? (j - i) * 16 : 0);
    frames.push_back(Frame{i, j, bytes, req_bytes});
    i = j;
  }

  const int64_t nframes = static_cast<int64_t>(frames.size());
  // Build every frame's wire header and one shared op-list arena up
  // front: the pipelined send loop below can then gather ALL frames
  // admitted by the window into a single vectored send. Sub-framed
  // scatter batches would otherwise pay one sendmsg per frame on the
  // request side — per-syscall cost is the scatter class's enemy.
  std::vector<WireReq> hdrs(static_cast<size_t>(nframes));
  std::vector<int64_t> all_ops(static_cast<size_t>(n) * 2);
  for (int64_t k = 0; k < n; ++k) {
    all_ops[2 * k] = ops[k].offset;
    all_ops[2 * k + 1] = ops[k].nbytes;
  }
  for (int64_t f = 0; f < nframes; ++f) {
    const Frame& fr = frames[f];
    const int64_t fn = fr.end - fr.begin;
    if (fn == 1)
      hdrs[static_cast<size_t>(f)] =
          WireReq{kMagic, kOpRead,
                  rank_,  static_cast<uint32_t>(name.size()),
                  ops[fr.begin].offset, ops[fr.begin].nbytes,
                  tspan};
    else
      hdrs[static_cast<size_t>(f)] =
          WireReq{kMagic, kOpReadVec,
                  rank_,  static_cast<uint32_t>(name.size()),
                  fn,     fr.bytes,
                  tspan};
  }
  std::vector<iovec> req_iovs;  // reused request gather list
  std::vector<iovec> iovs;      // reused scatter list
  std::vector<char> pack;       // small-op receive staging (kPackBytes)
  struct Fixup {
    char* src;
    void* dst;
    int64_t nbytes;
  };
  std::vector<Fixup> fixups;    // scratch -> final-destination copies
  int64_t sent = 0, recvd = 0, inflight_req = 0;
  while (recvd < nframes) {
    // Keep the pipeline full without overrunning socket buffers: bound
    // outstanding frames AND their unread request bytes (>= 1 frame
    // always allowed so the loop can't stall).
    req_iovs.clear();
    int64_t queued_req = inflight_req;
    int64_t burst = 0;
    // Half-window refill: the initial burst always gathers into one
    // vectored send, but the steady state used to top the window up one
    // frame per response — one sendmsg per FRAME, the per-frame sentry
    // tax all over again on the request side. Refill only once the
    // pipeline has drained to half the window, so steady-state request
    // traffic moves in ~window/2-frame writev bursts. Framing and frame
    // ORDER are untouched — the wire byte stream (and the server's
    // seeded fault-draw schedule) is identical to the one-at-a-time
    // refill; only the sendmsg boundaries move.
    if (sent == recvd || sent - recvd <= kPipelineWindow / 2) {
      while (sent < nframes && sent - recvd < kPipelineWindow &&
             (sent == recvd ||
              queued_req + frames[sent].req_bytes <= kPipelineReqBytes)) {
        const Frame& fr = frames[sent];
        req_iovs.push_back(iovec{&hdrs[static_cast<size_t>(sent)],
                                 sizeof(WireReq)});
        req_iovs.push_back(
            iovec{const_cast<char*>(name.data()), name.size()});
        if (fr.end - fr.begin > 1)
          req_iovs.push_back(
              iovec{&all_ops[static_cast<size_t>(2 * fr.begin)],
                    static_cast<size_t>(fr.end - fr.begin) * 16});
        queued_req += fr.req_bytes;
        ++sent;
        ++burst;
      }
    }
    if (!req_iovs.empty()) {
      if (SendIov(c.fd, req_iovs.data(),
                  static_cast<int>(req_iovs.size())) != 0)
        return fail();
      inflight_req = queued_req;
      req_frames_.fetch_add(burst, std::memory_order_relaxed);
      req_sends_.fetch_add(1, std::memory_order_relaxed);
    }
    WireResp resp;
    if (FullRecv(c.fd, &resp, sizeof(resp)) != 0) return fail();
    inflight_req -= frames[recvd].req_bytes;
    if (resp.status != kOk) {
      // Outstanding pipelined responses are still in flight; reset the
      // connection so the next ReadV can't consume a stale frame as fresh
      // data. EnsureConnected reconnects lazily.
      int status = resp.status;
      fail();
      return status;
    }
    const Frame& fr = frames[recvd];
    if (resp.nbytes != fr.bytes) return fail();
    if (fr.bytes > 0) {
      // Mirror of the server's hybrid framing: small ops land in one
      // contiguous staging block (consecutive ones share an iovec) and
      // are memcpy'd to their destinations afterwards; big ops receive
      // zero-copy. The recvmsg walk shrinks from per-row to ~per-frame.
      const int64_t fn = fr.end - fr.begin;
      int64_t packed = 0;
      for (int64_t k = 0; k < fn; ++k)
        if (ops[fr.begin + k].nbytes < kPackBytes)
          packed += ops[fr.begin + k].nbytes;
      if (static_cast<int64_t>(pack.size()) < packed)
        pack.resize(static_cast<size_t>(packed));
      iovs.clear();
      fixups.clear();
      char* sp = pack.data();
      bool prev_packed = false;
      for (int64_t k = 0; k < fn; ++k) {
        const ReadOp& op = ops[fr.begin + k];
        if (op.nbytes <= 0) continue;
        if (op.nbytes < kPackBytes) {
          fixups.push_back(Fixup{sp, op.dst, op.nbytes});
          if (prev_packed)
            iovs.back().iov_len += static_cast<size_t>(op.nbytes);
          else
            iovs.push_back(iovec{sp, static_cast<size_t>(op.nbytes)});
          sp += op.nbytes;
          prev_packed = true;
        } else {
          iovs.push_back(iovec{op.dst, static_cast<size_t>(op.nbytes)});
          prev_packed = false;
        }
      }
      if (RecvScatter(c.fd, iovs.data(), static_cast<int>(iovs.size()))
          != 0)
        return fail();
      for (const Fixup& fx : fixups)
        std::memcpy(fx.dst, fx.src, static_cast<size_t>(fx.nbytes));
      // Per-lane ledger, counted at frame completion: bytes that
      // actually landed (a failed/retried frame re-counts on the lane
      // that finally carries it, which is what utilization means).
      c.bytes.fetch_add(fr.bytes, std::memory_order_relaxed);
    }
    ++recvd;
  }
  return kOk;
}

int TcpTransport::ReadVOnRetry(Peer& p, int lane0, int nlanes,
                               const std::string& name, const ReadOp* ops,
                               int64_t n, int target, int lane_off) {
  // Transport-level failures (connection reset, truncated frame, read
  // timeout, failed dial) are transient: a retry can save the op —
  // ReadVOn resets the failed lane and the retry ROTATES to the next
  // lane of this stripe set (connected and serving a moment ago, so the
  // retry usually rides a warm surviving stream instead of paying a
  // redial; the closed lane redials lazily on its next use). Retries
  // are idempotent (every op rewrites its own dst span; a failed
  // pipelined frame resets its connection so no stale response can be
  // consumed as fresh data), and with nlanes == 1 the rotation is the
  // identity — the exact pre-lane behavior.
  // Classification/backoff/counter policy lives in RetryTransientLoop,
  // shared with the Store-level layer.
  if (nlanes < 1) nlanes = 1;
  const size_t pool = p.conns.size();
  // Window index -> pool index (tenant QoS rotation; off 0 on a
  // prefix window is the identity).
  const auto pool_lane = [&](int wi) {
    return static_cast<size_t>(lane_off + wi) % pool;
  };
  int att = 0;
  Conn* used = p.conns[pool_lane(lane0)].get();
  // Snapshot the store's suspect oracle ONCE per leaf (one uncontended
  // lock amortized over the whole pipelined frame sequence); the
  // per-attempt checks below are then plain calls into the store's
  // relaxed atomic flags, never a shared mutex on the hot path.
  std::function<bool(int)> oracle;
  {
    std::lock_guard<std::mutex> lock(oracle_mu_);
    oracle = suspect_oracle_;
  }
  std::function<bool()> suspect;
  if (oracle)
    // Detector verdict aborts the ladder without a giveup: the
    // failover layer reroutes this stripe onto the peer's replica set
    // in O(heartbeat) instead of O(deadline). Unset oracle (no store
    // attached / single-rank) = never suspected.
    suspect = [o = std::move(oracle), target]() { return o(target); };
  const int rc = RetryTransientLoop(
      retry_, target, &stopping_,
      static_cast<uint64_t>(target) * 0x9e3779b97f4a7c15ULL +
          static_cast<uint64_t>(lane0),
      [&]() {
        used = p.conns[pool_lane((lane0 + att) % nlanes)].get();
        return ReadVOn(p, *used, name, ops, n);
      },
      [&]() {
        // The failed attempt closed ITS lane (ReadVOn's fail(), or a
        // dial that never opened it); count the redial the stripe now
        // owes. The fd is read under the lane's lock: another stripe may
        // be redialling the same lane.
        bool closed;
        {
          std::lock_guard<std::mutex> lane(used->mu);
          closed = used->fd < 0;
        }
        if (closed)
          retry_.reconnects.fetch_add(1, std::memory_order_relaxed);
        ++att;  // rotate: the next attempt runs on the next lane
      },
      retry_deadline_ns_.load(std::memory_order_relaxed) * 1e-9,
      suspect);
  if (rc == kErrPeerLost && DebugOn())
    std::fprintf(stderr, "[dds r%d] read to r%d exhausted retry budget "
                 "-> peer lost\n", rank_, target);
  return rc;
}

// A single TCP stream can't saturate loopback or a DCN NIC. Large requests
// are split into ~kStripeBytes pieces and the op list is partitioned
// round-robin by bytes across the peer's connection pool; each pool member
// runs the pipelined loop against its own serving thread on the target.
constexpr int64_t kStripeBytes = 1 << 22;

int TcpTransport::ReadV(int target, const std::string& name, const ReadOp* ops,
                        int64_t n) {
  PeerReadV req{target, ops, n};
  return ReadVMulti(name, &req, 1);
}

bool TcpTransport::ProbeCmaInfoLocked(Peer& p, Conn& c,
                                      std::string* payload) {
  // ANY failure after the request is sent must reset the connection
  // (same convention as ReadVOn's fail()): a late CmaInfo response
  // left in the stream would be consumed by the next TCP read as its
  // own.
  if (EnsureConnected(p, c) != kOk) return false;
  WireReq req{kMagic, kOpCmaInfo, rank_, 0, 0, 0, 0};
  WireResp resp;
  bool ok = FullSend(c.fd, &req, sizeof(req)) == 0 &&
            FullRecv(c.fd, &resp, sizeof(resp)) == 0 &&
            resp.status == kOk && resp.nbytes > 0 && resp.nbytes <= 4096;
  if (ok) {
    payload->resize(static_cast<size_t>(resp.nbytes));
    ok = FullRecv(c.fd, &(*payload)[0], payload->size()) == 0;
  }
  if (!ok) {
    ::close(c.fd);
    c.fd = -1;
  }
  return ok;
}

CmaPeer* TcpTransport::EnsureCmaPeer(Peer& p, int target) {
  if (!cma_reg_) return nullptr;  // if we can't publish, don't probe either
  uint64_t gen;
  {
    // Claim the one-shot probe (0 -> 2) or return the settled verdict.
    // cma_mu is DDS_NO_BLOCKING: the dial+info round trip below runs
    // with NO lock held, so concurrent classification peeks never
    // stall behind a first-contact probe — they ride TCP this once and
    // pick up the verdict on their next read (ROADMAP item 6).
    std::lock_guard<std::mutex> lock(p.cma_mu);
    if (p.cma_state == 1 && p.cma && p.cma->denied()) p.cma_state = -1;
    if (p.cma_state == 1) return p.cma.get();
    if (p.cma_state != 0) return nullptr;  // -1: TCP only; 2: probing
    p.cma_state = 2;
    gen = p.cma_gen;
  }

  // Info exchange over the peer's first connection, serialized by that
  // lane's OWN mutex (a data-lane mutex, legitimately held across wire
  // I/O).
  CmaPeer* opened = nullptr;
  bool probe_ok = false;
  std::string payload;
  {
    Conn& c = *p.conns[0];
    std::lock_guard<std::mutex> clock(c.mu);
    probe_ok = ProbeCmaInfoLocked(p, c, &payload);
  }
  if (probe_ok) {
    long pid = 0;
    unsigned long long start = 0;
    char token[160] = {0}, shm[96] = {0};
    if (std::sscanf(payload.c_str(), "%ld %llu %159s %95s", &pid,
                    &start, token, shm) == 4 &&
        CmaHostToken() == token && std::strcmp(shm, "-") != 0) {
      opened = CmaPeer::Open(shm, pid, start);
      if (opened && DebugOn())
        std::fprintf(stderr, "[dds r%d] CMA fast path to r%d (pid %ld)\n",
                     rank_, target, pid);
    }
  }

  // Publish the verdict — unless UpdatePeer crossed the probe (gen
  // bumped): the opened mapping would belong to the DEAD process, so
  // discard it and leave the state wherever UpdatePeer reset it (the
  // next read against the replacement re-probes from scratch).
  std::lock_guard<std::mutex> lock(p.cma_mu);
  if (p.cma_gen != gen) {
    delete opened;  // never published, no concurrent user possible
    return nullptr;
  }
  if (!opened) {
    p.cma_state = -1;  // one probe; failure leaves the peer on TCP
    return nullptr;
  }
  p.cma.reset(opened);
  p.cma_state = 1;
  return p.cma.get();
}

// Bulk threshold for adaptive routing: matches the point where CMA part
// striping engages (2 x kCmaChunk). Below it the per-request cost is
// latency-dominated for single reads; MANY-op batches below it form the
// scatter class, routed by its own estimate.
constexpr int64_t kBulkBytes = 8 << 20;
// A same-host request with at least this many ops (and < kBulkBytes
// total) is scatter-class: per-op overhead dominates, and which path
// carries that overhead cheaper is a property of the kernel/NIC, not of
// the bulk bandwidth — measured separately.
constexpr int64_t kScatterMinOps = 64;
bool TcpTransport::RouteViaTcp(RouteClass& rc) {
  // The pin env ("1" = always CMA, "0" = always TCP) is read per call so
  // benches/tests can flip it at runtime. The USER pin outranks the
  // planner pin, which outranks the adaptive estimate.
  if (const char* env = ::getenv(rc.pin_env)) {
    if (env[0] == '1') return false;
    if (env[0] == '0') return true;
  }
  const int pin = route_pin_[rc.cls].load(std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(route_mu_);
  const int64_t d = rc.decisions++;
  if (pin >= 0) {
    // A planner pin decides the route but must NOT freeze the
    // substrate: keep the steady-state probe cadence below (a paired
    // window on the other path every 32 decisions, the pair's first
    // discarded) so BOTH cells stay fresh and the next replan judges
    // live numbers — a pin that also stopped probing would re-confirm
    // itself from frozen data forever. Only the USER env pin above is
    // absolute (forced-path benches rely on exact forcing).
    const int phase = static_cast<int>(d & 31);
    if (phase == 30) rc.discard_probe = true;
    const bool probe = phase >= 30;
    const bool pinned_tcp = pin == 1;
    return probe ? !pinned_tcp : pinned_tcp;
  }
  // Sample collection: alternate onto whichever path is under-sampled
  // until BOTH have kWarmMinSamples clean measurements. One sample per
  // path is not a comparison — the first TCP window used to pay
  // connection setup and park the verdict on a number ~6x under the warm
  // path (and connect-tainted windows are now discarded entirely, see
  // RecordRouteSample, so collection keeps routing a path until a clean
  // sample actually lands).
  // Consecutively per path (CMA's windows first, then TCP's), not
  // alternating: an isolated window on a path that just sat idle times
  // the re-warm (TCP slow-start restart, sleeping pool threads), and
  // alternation makes EVERY collection window isolated.
  if (rc.cma.n < kWarmMinSamples) return false;
  if (rc.tcp.n < kWarmMinSamples) return true;
  // Steady state: periodically probe the non-preferred path so a stale
  // estimate can recover (e.g. the kernel's CMA emulation cost changing,
  // or socket buffers autotuning up). Probes come as a PAIR of
  // consecutive windows every 32 reads — same 1-in-16 slow-path budget
  // as the old every-16th singleton, but the pair's first window only
  // re-warms the idle path and its sample is discarded (discard_probe);
  // the second is the measurement. An estimate built from cold
  // singletons would tell the router how fast the path WAKES (TCP
  // slow-start restart, sleeping pool threads), not how fast it runs.
  const int phase = static_cast<int>(d & 31);
  // Single-shot arm, consumed by the next non-preferred sample. If the
  // warm-up window's sample is lost (failed read, hygiene drop), the
  // flag instead eats the pair's second sample and the round records
  // nothing — self-healing, since the next round re-arms and measures
  // normally. Deliberately NOT disarmed at the phase-31 decision: with
  // concurrent readers that decision can run before the warm-up
  // window's sample lands, and disarming early would fold the cold
  // re-warm measurement into the EWMA.
  if (phase == 30) rc.discard_probe = true;
  const bool probe = phase >= 30;
  return probe ? !rc.via_tcp : rc.via_tcp;
}

void TcpTransport::RecordRouteSample(RouteClass& rc, bool via_tcp,
                                     int64_t bytes, double secs, bool cold) {
  if (bytes <= 0 || secs <= 0.0) return;
  const double bw = static_cast<double>(bytes) / secs;
  std::lock_guard<std::mutex> lock(route_mu_);
  // Hygiene is the shared substrate's (measure.h): dial-tainted
  // windows discarded while the cell is unseeded (bounded by the
  // class-shared skip budget), each cell's first clean window consumed
  // as its warm-up, and the armed probe-pair discard eaten by the next
  // non-preferred-path sample (the pair's first window only re-warmed
  // the idle path; the one after it is the measurement).
  WarmStat& cell = via_tcp ? rc.tcp : rc.cma;
  bool* probe = via_tcp != rc.via_tcp ? &rc.discard_probe : nullptr;
  if (FoldWarmSample(cell, bw, cold, &rc.cold_skips, probe) !=
      WarmFold::kFolded)
    return;
  if (rc.cma.ewma == 0.0 || rc.tcp.ewma == 0.0) return;
  // One-shot warm calibration: the first moment BOTH paths hold clean
  // warm estimates, park the class on the measured-faster one outright.
  // Hysteresis exists to stop steady-state flapping between paths the
  // EWMA ranks near-equal — applying it to the INITIAL verdict instead
  // parked a cold start on whichever path happened to be the default
  // whenever the faster one won by less than the band.
  bool flip_to_tcp, flip_to_cma;
  if (!rc.calibrated && rc.cma.n >= kWarmMinSamples &&
      rc.tcp.n >= kWarmMinSamples) {
    rc.calibrated = true;
    flip_to_tcp = !rc.via_tcp && rc.tcp.ewma > rc.cma.ewma;
    flip_to_cma = rc.via_tcp && rc.cma.ewma > rc.tcp.ewma;
  } else {
    // Per-class hysteresis: flapping between near-equal paths costs
    // probes and log noise for no bandwidth (1.25x bulk, 1.1x scatter).
    flip_to_tcp = !rc.via_tcp && rc.tcp.ewma > rc.hysteresis * rc.cma.ewma;
    flip_to_cma = rc.via_tcp && rc.cma.ewma > rc.hysteresis * rc.tcp.ewma;
  }
  if (flip_to_tcp || flip_to_cma) {
    rc.via_tcp = flip_to_tcp;
    ++rc.crossovers;
    std::fprintf(stderr,
                 "[dds r%d] %s reads now routed via %s (CMA %.2f GB/s "
                 "vs TCP %.2f GB/s)\n",
                 rank_, rc.name, flip_to_tcp ? "TCP" : "CMA",
                 rc.cma.ewma / 1e9, rc.tcp.ewma / 1e9);
  }
}

void TcpTransport::RoutingState(int cls, double* cma_bw, double* tcp_bw,
                                int64_t* decisions, int64_t* crossovers,
                                int* via_tcp, int* calibrated) {
  std::lock_guard<std::mutex> lock(route_mu_);
  const RouteClass& rc = cls == 1 ? scatter_route_ : bulk_route_;
  *cma_bw = rc.cma.ewma;
  *tcp_bw = rc.tcp.ewma;
  *decisions = rc.decisions;
  *crossovers = rc.crossovers;
  *via_tcp = rc.via_tcp ? 1 : 0;
  *calibrated = rc.calibrated ? 1 : 0;
}

// A level must beat its predecessor's throughput by this factor to keep
// the ramp going; below it, per-lane throughput has stopped scaling and
// the extra streams are pure dispatch/syscall overhead.
constexpr double kLaneGrowth = 1.15;

int TcpTransport::StripeLanes(LaneTuner& t) {
  std::lock_guard<std::mutex> lock(lane_mu_);
  const int pin = lane_pin_[t.cls].load(std::memory_order_relaxed);
  if (pin >= 1) {
    const int pool = t.levels.empty() ? 1 : t.levels.back();
    return pin < pool ? pin : pool;
  }
  return t.parked ? t.active : t.levels[static_cast<size_t>(t.level)];
}

void TcpTransport::RecordLaneSample(LaneTuner& t, int lanes,
                                    int64_t bytes, double secs,
                                    bool cold) {
  if (bytes <= 0 || secs <= 0.0) return;
  const double bw = static_cast<double>(bytes) / secs;
  std::lock_guard<std::mutex> lock(lane_mu_);
  if (lane_pin_[t.cls].load(std::memory_order_relaxed) >= 1) {
    // Planner-pinned width: ramp/park decisions are suspended, but the
    // substrate keeps measuring — fold into the level matching the
    // pinned width (if it is one of the tuner's levels) so a later
    // replan sees fresh numbers for the width actually run.
    for (size_t i = 0; i < t.levels.size(); ++i) {
      if (t.levels[i] != lanes) continue;
      if (FoldWarmSample(t.stats[i], bw, cold, &t.cold_skips, nullptr) ==
          WarmFold::kFolded)
        ++t.samples;
      break;
    }
    return;
  }
  if (t.parked) return;
  const size_t lv = static_cast<size_t>(t.level);
  // Concurrent batches (depth>1 readahead windows) can complete after
  // the level advanced; a sample measured at a different width says
  // nothing about the current level.
  if (lanes != t.levels[lv]) return;
  // Hygiene is the shared substrate's (measure.h): dial-tainted
  // windows discarded while the level is unseeded (per-tuner bounded
  // budget — a peer set that redials every window must not pin the
  // ramp at level 0 forever), and each level's first clean window
  // consumed as its warm-up (it re-warms idle lanes/pool threads).
  if (FoldWarmSample(t.stats[lv], bw, cold, &t.cold_skips, nullptr) !=
      WarmFold::kFolded)
    return;
  ++t.samples;
  if (t.stats[lv].n < kWarmMinSamples) return;
  const bool scaled =
      t.level == 0 ||
      t.stats[lv].ewma >
          kLaneGrowth * t.stats[static_cast<size_t>(t.level - 1)].ewma;
  if (scaled && lv + 1 < t.levels.size()) {
    ++t.level;  // keep ramping: the last doubling still paid
    return;
  }
  // Ramp over (growth stalled, or the pool size is fully measured):
  // park on the best-measured level outright.
  size_t best = 0;
  for (size_t i = 1; i <= lv; ++i)
    if (t.stats[i].ewma > t.stats[best].ewma) best = i;
  t.parked = true;
  t.active = t.levels[best];
  std::fprintf(stderr,
               "[dds r%d] %s striped reads parked at %d lane(s) "
               "(%.2f GB/s; next level %s)\n",
               rank_, t.name, t.active, t.stats[best].ewma / 1e9,
               scaled ? "unmeasured (pool cap)" : "stopped scaling");
}

void TcpTransport::LaneState(int64_t out[8]) {
  std::lock_guard<std::mutex> lock(lane_mu_);
  const LaneTuner& t = bulk_lanes_;
  double best = 0.0;
  for (const WarmStat& s : t.stats) best = s.ewma > best ? s.ewma : best;
  const int pool = t.levels.empty() ? 1 : t.levels.back();
  // A planner pin is what striped reads actually engage; report it as
  // the active width (and as "parked": the ramp is suspended).
  const int bulk_pin = lane_pin_[0].load(std::memory_order_relaxed);
  const int sc_pin = lane_pin_[1].load(std::memory_order_relaxed);
  out[0] = pool;
  out[1] = bulk_pin >= 1 ? (bulk_pin < pool ? bulk_pin : pool)
                         : (t.parked ? t.active
                                     : t.levels[static_cast<size_t>(
                                           t.level)]);
  out[2] = (t.parked || bulk_pin >= 1) ? 1 : 0;
  out[3] = t.autotune ? 1 : 0;
  out[4] = t.samples + scatter_lanes_.samples;
  out[5] = static_cast<int64_t>(best);
  const LaneTuner& sc = scatter_lanes_;
  out[6] = sc_pin >= 1 ? (sc_pin < pool ? sc_pin : pool)
                       : (sc.parked ? sc.active
                                    : sc.levels[static_cast<size_t>(
                                          sc.level)]);
  out[7] = (sc.parked || sc_pin >= 1) ? 1 : 0;
}

int TcpTransport::PinRoute(int cls, int mode) {
  if (cls < 0 || cls > 1 || mode < -1 || mode > 1) return kErrInvalidArg;
  route_pin_[cls].store(mode, std::memory_order_relaxed);
  if (mode >= 0) {
    // Align the router's preference with the pin: RecordRouteSample
    // classifies probe-pair windows by `via_tcp != rc.via_tcp`, and
    // the probes RouteViaTcp sends under a pin target the non-PINNED
    // path. (Also the sane release state: dropping the pin resumes
    // adaptive routing from the pinned path, hysteresis governing any
    // later flip.)
    std::lock_guard<std::mutex> lock(route_mu_);
    (cls == 1 ? scatter_route_ : bulk_route_).via_tcp = mode == 1;
  }
  return kOk;
}

int TcpTransport::PinLanes(int cls, int lanes) {
  if (cls < 0 || cls > 1 || lanes == 0 || lanes < -1 || lanes > 64)
    return kErrInvalidArg;
  lane_pin_[cls].store(lanes, std::memory_order_relaxed);
  return kOk;
}

int TcpTransport::SchedCells(double* out, int cap) {
  if (!out || cap < 0) return kErrInvalidArg;
  int rows = 0;
  auto put = [&](double src, double cls, double knob, const WarmStat& s) {
    if (rows >= cap) return;
    double* r = out + static_cast<size_t>(rows) * 5;
    r[0] = src;
    r[1] = cls;
    r[2] = knob;
    r[3] = s.ewma;
    r[4] = static_cast<double>(s.n);
    ++rows;
  };
  {
    std::lock_guard<std::mutex> lock(route_mu_);
    for (const RouteClass* rc : {&bulk_route_, &scatter_route_}) {
      put(0, rc->cls, 0, rc->cma);
      put(0, rc->cls, 1, rc->tcp);
    }
  }
  {
    std::lock_guard<std::mutex> lock(lane_mu_);
    for (const LaneTuner* t : {&bulk_lanes_, &scatter_lanes_})
      for (size_t i = 0; i < t->levels.size(); ++i)
        put(1, t->cls, t->levels[i], t->stats[i]);
  }
  return rows;
}

int TcpTransport::LaneBytes(int target, int64_t* out, int cap) {
  if (!out || cap <= 0) return 0;
  // Same target validation as the read entry points: an out-of-range
  // rank must error, not read as "no traffic to that peer".
  if (target < -1 || target >= world_) return kErrInvalidArg;
  int nlanes = 0;
  for (const auto& p : peers_)
    if (p) nlanes = std::max(nlanes, static_cast<int>(p->conns.size()));
  nlanes = std::min(nlanes, cap);
  for (int i = 0; i < nlanes; ++i) out[i] = 0;
  for (int r = 0; r < world_; ++r) {
    if (target >= 0 && r != target) continue;
    const Peer& p = *peers_[r];
    for (size_t ci = 0;
         ci < p.conns.size() && ci < static_cast<size_t>(nlanes); ++ci)
      out[ci] += p.conns[ci]->bytes.load(std::memory_order_relaxed);
  }
  return nlanes;
}

int TcpTransport::ReadVMulti(const std::string& name, const PeerReadV* reqs,
                             int64_t nreqs,
                             const std::string& as_tenant) {
  // Same-host fast path first: whole per-peer op lists served with
  // process_vm_readv (no sockets, no serving thread, one kernel copy),
  // peers in parallel on the pool (the kernel copy runs at one core's
  // memcpy speed; distinct peers are independent). Anything the fast
  // path can't take — cross-host peers, a mapping mid-rebind, a probe
  // denial — falls through to the TCP leaves below.
  std::vector<PeerReadV> rest;
  if (cma_reg_) {
    // One process_vm_readv copies at a single core's memcpy speed; big
    // reads are split into ~4 MiB chunks dealt across up to 8 parallel
    // part-lists per peer (mirrors the TCP path's connection striping).
    constexpr int64_t kCmaChunk = 4 << 20;
    constexpr int kCmaMaxPar = 8;
    constexpr int64_t kCmaMinOpsPerPart = 256;
    struct CmaTry {
      const PeerReadV* rq;
      CmaPeer* peer;
      int64_t bytes;
      std::vector<std::vector<ReadOp>> owned;  // backing when split
      // (ops, n) views: the caller's array for single-part requests (no
      // copy on the common small-read path), `owned` when split.
      std::vector<std::pair<const ReadOp*, int64_t>> spans;
      std::vector<int> results;
    };
    std::vector<CmaTry> tries;
    rest.reserve(static_cast<size_t>(nreqs));
    // Suspect gate for the same-host leg: a SUSPECTED peer's still-
    // mapped /dev/shm shard would keep serving bytes silently — masking
    // the failover the detector just decided on (and, post-recovery,
    // serving a shard the replacement has rolled back). Route suspected
    // owners to the wire leaves below, whose per-attempt oracle check
    // surfaces kErrPeerLost immediately so the store's replica router
    // takes over. Snapshotted once per batch, same discipline as
    // ReadVOnRetry.
    std::function<bool(int)> cma_suspect;
    {
      std::lock_guard<std::mutex> lock(oracle_mu_);
      cma_suspect = suspect_oracle_;
    }
    for (int64_t ri = 0; ri < nreqs; ++ri) {
      const PeerReadV& rq = reqs[ri];
      CmaPeer* peer = nullptr;
      int64_t total = 0;
      for (int64_t i = 0; i < rq.n; ++i) total += rq.ops[i].nbytes;
      // Bulk and scattered requests each go to whichever path measures
      // faster for THEIR class (see RouteViaTcp); small few-op reads
      // always prefer CMA (it wins on latency wherever it works).
      const bool scatter_class = total < kBulkBytes &&
                                 rq.n >= kScatterMinOps;
      bool want_cma = true;
      if (total >= kBulkBytes)
        want_cma = !RouteBulkViaTcp();
      else if (scatter_class)
        want_cma = !RouteScatterViaTcp();
      if (want_cma && rq.target >= 0 && rq.target < world_ &&
          rq.target != rank_ && rq.n > 0 &&
          !(cma_suspect && cma_suspect(rq.target)))
        peer = EnsureCmaPeer(*peers_[rq.target], rq.target);
      if (!peer) {
        rest.push_back(rq);
        continue;
      }
      CmaTry t{&rq, peer, total, {}, {}, {}};
      int nparts = 1;
      if (total > 2 * kCmaChunk) {
        nparts = static_cast<int>(std::min<int64_t>(
            kCmaMaxPar, (total + kCmaChunk - 1) / kCmaChunk));
      } else if (rq.n >= 2 * kCmaMinOpsPerPart) {
        // Scattered batch (many small rows, modest bytes): one
        // process_vm_readv walks every segment on a single core, so
        // spread whole ops across parallel part-lists the same way the
        // TCP path stripes them across connections — the per-segment
        // kernel cost then rides every core, not one.
        nparts = static_cast<int>(std::min<int64_t>(
            kCmaMaxPar, rq.n / kCmaMinOpsPerPart));
      }
      // The kernel copy is CPU-bound: more part-lists than cores is pure
      // dispatch overhead (measured 0.30 vs 0.43 GB/s scattered on a
      // 1-core box).
      nparts = static_cast<int>(std::min<unsigned>(
          static_cast<unsigned>(nparts), hw_cores_));
      if (nparts == 1) {
        t.spans.emplace_back(rq.ops, rq.n);
      } else {
        t.owned = DealChunks(rq.ops, rq.n, kCmaChunk, nparts);
        for (const auto& part : t.owned)
          if (!part.empty())
            t.spans.emplace_back(part.data(),
                                 static_cast<int64_t>(part.size()));
      }
      t.results.assign(t.spans.size(), CmaPeer::kCmaFallback);
      tries.push_back(std::move(t));
    }
    if (!tries.empty()) {
      const auto cma_t0 = std::chrono::steady_clock::now();
      TaskGroup group(&pool_);
      bool first = true;
      CmaTry* inline_try = nullptr;
      size_t inline_pi = 0;
      for (CmaTry& t : tries) {
        for (size_t pi = 0; pi < t.spans.size(); ++pi) {
          if (first) {  // one leaf inline for guaranteed progress
            inline_try = &t;
            inline_pi = pi;
            first = false;
            continue;
          }
          CmaTry* tp = &t;
          int* res = &t.results[pi];
          const auto* span = &t.spans[pi];
          group.Launch([tp, res, span, &name]() {
            *res = tp->peer->TryReadV(name, span->first, span->second);
          });
        }
      }
      if (inline_try)
        inline_try->results[inline_pi] = inline_try->peer->TryReadV(
            name, inline_try->spans[inline_pi].first,
            inline_try->spans[inline_pi].second);
      group.Wait();
      int64_t cma_ok_bytes = 0;
      bool cma_all_ok = true, cma_any_bulk = false, cma_any_scatter = false;
      for (CmaTry& t : tries) {
        bool ok = true;
        for (int r : t.results) ok = ok && r == kOk;
        if (ok) {
          cma_ops_.fetch_add(t.rq->n, std::memory_order_relaxed);
          // ddmetrics route attribution, from the op's own thread
          // (span_latency's rule: cma wins over tcp).
          metrics::OpTimer::MarkRoute(metrics::kRouteCma);
          trace::Ev(trace::kCmaRead, rank_, t.rq->target, t.rq->n,
                    t.bytes);
          cma_ok_bytes += t.bytes;
          cma_any_bulk = cma_any_bulk || t.bytes >= kBulkBytes;
          // Scatter-class = a SINGLE request with >= kScatterMinOps ops
          // (same per-request rule the routing decision and the TCP-side
          // sample use) — an aggregate op count over many few-op
          // requests would feed latency-dominated multi-peer batches
          // into the scatter estimate one-sidedly.
          cma_any_scatter = cma_any_scatter ||
                            (t.bytes < kBulkBytes &&
                             t.rq->n >= kScatterMinOps);
        } else {
          // All-or-nothing per peer: TCP redoes the whole request (the
          // parts that DID land wrote the same bytes TCP will write).
          rest.push_back(*t.rq);
          cma_all_ok = false;
        }
      }
      // Sample hygiene: each estimate drives its class's routing, so
      // feed it only clean measurements of that class — bulk needs at
      // least one single request over the threshold (an 8 MiB
      // *aggregate* of scattered rows measures per-op overhead, not
      // bandwidth); scatter needs NO bulk request in the batch (the
      // bulk copy would dominate the wall time); and neither takes
      // failed tries (their time stays in the window but their bytes
      // don't).
      if (cma_all_ok && (cma_any_bulk || cma_any_scatter)) {
        const double secs = std::chrono::duration<double>(
            std::chrono::steady_clock::now() - cma_t0).count();
        RecordRouteSample(cma_any_bulk ? bulk_route_ : scatter_route_,
                          /*via_tcp=*/false, cma_ok_bytes, secs);
      }
    }
    if (rest.empty()) return kOk;
    reqs = rest.data();
    nreqs = static_cast<int64_t>(rest.size());
  }
  // Flatten peers × striped lanes into one leaf-task list, then run
  // the leaves on the persistent pool (one inline for guaranteed
  // progress). Flat leaves mean pool tasks never wait on nested pool
  // tasks, so the pool cannot self-deadlock.
  struct Leaf {
    Peer* p;
    int lane;    // window index of this stripe's lane
    int nlanes;  // lanes this request striped over (retry rotation set)
    int target;  // peer rank, for retry classification/diagnostics
    std::vector<ReadOp> ops;
    int off = 0; // pool offset of the lane window (tenant QoS rotation;
                 // 0 for unbudgeted traffic = the pool prefix, exactly
                 // the pre-tenancy lane assignment)
  };
  std::vector<Leaf> leaves;
  // Pass 1 — validate and classify. Each request's byte total is
  // computed ONCE and cached (the leaf pass below reuses it; op lists
  // run to 16k+ entries on scatter batches). Lane-tuner class: BULK
  // when any request's bytes reach the byte-striping threshold,
  // otherwise SCATTER when any op count reaches the dealing threshold
  // (judged against the POOL size — the level-1 windows that seed the
  // tuner ramp run unstriped by definition, yet they are exactly the
  // 1-lane baseline the higher levels are compared against). Routing
  // hygiene rides the same pass: a TCP bandwidth sample is only
  // meaningful to the CMA/TCP routing decision if it measures traffic
  // CMA could have carried instead — bulk needs one bulk-sized request
  // to a CMA-capable peer and no cross-host leaves (mixed batches
  // would let DCN reads drag the estimate, or inflate it when they
  // parallelize); scatter additionally needs NO bulk request (its copy
  // time would drown the per-op signal).
  bool lane_bulk = false, lane_scatter = false;
  bool tcp_bulk_routable = false;
  bool tcp_scatter_routable = false;
  bool any_bulk_req = false;
  bool all_cma = true;
  int64_t tcp_bytes = 0;
  std::vector<int64_t> req_totals(static_cast<size_t>(nreqs), 0);
  for (int64_t ri = 0; ri < nreqs; ++ri) {
    const PeerReadV& rq = reqs[ri];
    if (rq.target < 0 || rq.target >= world_ || rq.target == rank_)
      return kErrInvalidArg;
    if (rq.n == 0) continue;
    Peer& p = *peers_[rq.target];
    const int64_t pool = static_cast<int64_t>(p.conns.size());
    int64_t total = 0;
    for (int64_t i = 0; i < rq.n; ++i) total += rq.ops[i].nbytes;
    req_totals[static_cast<size_t>(ri)] = total;
    tcp_bytes += total;
    if (pool > 1) {
      if (total >= 2 * kStripeBytes) lane_bulk = true;
      else if (rq.n >= 2 * pool) lane_scatter = true;
    }
    std::lock_guard<std::mutex> lock(p.cma_mu);
    const bool cma_ok = p.cma_state == 1;
    if (total >= kBulkBytes) tcp_bulk_routable |= cma_ok;
    else if (rq.n >= kScatterMinOps) tcp_scatter_routable |= cma_ok;
    any_bulk_req = any_bulk_req || total >= kBulkBytes;
    all_cma = all_cma && cma_ok;
  }
  // ddmetrics route attribution: anything left here rides the wire
  // leaves (marked on the op's own thread — the pool leaves below run
  // without a token; cma above outranks this mark).
  for (int64_t ri = 0; ri < nreqs; ++ri)
    if (reqs[ri].n > 0) {
      metrics::OpTimer::MarkRoute(WireRouteLabel());
      break;
    }
  // One lane-count decision per batch, from the matching class's
  // tuner: the tuner's sample is bytes/wall-time over the WHOLE batch,
  // so every request in it must have striped at the same width for the
  // sample to mean anything.
  LaneTuner& lane_tuner = lane_bulk ? bulk_lanes_ : scatter_lanes_;
  int stripe_lanes = StripeLanes(lane_tuner);
  // Per-tenant QoS lane budget (planner-set share split): a budgeted
  // tenant's batch engages at most its budget, so one tenant's bulk
  // stripes cannot monopolize every lane/serving thread. Zero cost
  // (one relaxed load) until a budget is configured. When the budget
  // actually narrows this batch, the tenant's lane WINDOW rotates one
  // pool slot per batch (see TenantLaneBudget) so the narrowed tenant
  // time-shares the pool instead of pinning the prefix lanes.
  uint64_t lane_rot = 0;
  const int budget = TenantLaneBudget(name, &lane_rot, as_tenant);
  const bool budget_capped = budget > 0 && budget < stripe_lanes;
  if (budget_capped) {
    stripe_lanes = budget;
    trace::Ev(trace::kLaneBudgetRotate, rank_, budget,
              static_cast<int64_t>(lane_rot), 0);
  }
  const bool lane_sample = lane_bulk || lane_scatter;

  // Pass 2 — build the peer × lane leaves. Fan out across the lane set
  // when EITHER the bytes justify striping big ops OR the op count
  // justifies spreading per-op serving cost. The second clause is the
  // scattered-batch pattern (a DistributedSampler permutation):
  // hundreds of small rows per peer never reach the byte threshold,
  // yet one connection serializes them behind a single serving thread
  // — dealing whole ops round-robin engages nconn serving threads on
  // the target.
  for (int64_t ri = 0; ri < nreqs; ++ri) {
    const PeerReadV& rq = reqs[ri];
    if (rq.n == 0) continue;
    Peer& p = *peers_[rq.target];
    const int pool = static_cast<int>(p.conns.size());
    const int nconn = std::min(stripe_lanes, pool);
    const int off =
        budget_capped && pool > 0 ? static_cast<int>(lane_rot % pool) : 0;
    const int64_t total = req_totals[static_cast<size_t>(ri)];
    if (nconn <= 1 ||
        (total < 2 * kStripeBytes && rq.n < 2 * nconn)) {
      leaves.push_back(Leaf{&p, 0, 1, rq.target,
                            std::vector<ReadOp>(rq.ops, rq.ops + rq.n),
                            off});
      continue;
    }

    // Chunk big ops, then deal chunks round-robin (they are similar
    // sizes, so this balances bytes well without a sort).
    std::vector<std::vector<ReadOp>> lists =
        DealChunks(rq.ops, rq.n, kStripeBytes, nconn);
    for (int ci = 0; ci < nconn; ++ci)
      if (!lists[ci].empty())
        leaves.push_back(Leaf{&p, ci, nconn, rq.target,
                              std::move(lists[ci]), off});
  }
  if (leaves.empty()) return kOk;

  const int64_t dials0 = dials_.load(std::memory_order_relaxed);
  const auto tcp_t0 = std::chrono::steady_clock::now();
  std::vector<int> rcs(leaves.size(), kOk);
  TaskGroup group(&pool_);
  {
    // One enqueue pass under one pool lock: a lane-striped window fetch
    // dispatches peers × lanes leaves at once, and per-leaf lock+notify
    // is measurable dispatch overhead at that fan-out.
    std::vector<std::function<void()>> tasks;
    tasks.reserve(leaves.size() > 0 ? leaves.size() - 1 : 0);
    for (size_t li = 1; li < leaves.size(); ++li) {
      Leaf* lf = &leaves[li];
      int* rc = &rcs[li];
      tasks.emplace_back([this, lf, &name, rc]() {
        *rc = ReadVOnRetry(*lf->p, lf->lane, lf->nlanes, name,
                           lf->ops.data(),
                           static_cast<int64_t>(lf->ops.size()),
                           lf->target, lf->off);
      });
    }
    group.LaunchMany(std::move(tasks));
  }
  rcs[0] = ReadVOnRetry(*leaves[0].p, leaves[0].lane, leaves[0].nlanes,
                        name, leaves[0].ops.data(),
                        static_cast<int64_t>(leaves[0].ops.size()),
                        leaves[0].target, leaves[0].off);
  group.Wait();
  for (int rc : rcs)
    if (rc != kOk) return rc;
  const double tcp_secs = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - tcp_t0).count();
  const bool tcp_cold =
      dials_.load(std::memory_order_relaxed) != dials0;
  // Lane-tuner sample: a batch with at least one stripe/deal-eligible
  // request, at this batch's uniform lane width, folded into ITS
  // class's tuner. Cross-host batches count too — the tuner measures
  // the wire path itself, not a CMA comparison.
  if (lane_sample)
    RecordLaneSample(lane_tuner, stripe_lanes, tcp_bytes, tcp_secs,
                     tcp_cold);
  const bool bulk_sample = tcp_bulk_routable && all_cma;
  const bool scatter_sample =
      tcp_scatter_routable && all_cma && !any_bulk_req;
  if (bulk_sample || scatter_sample) {
    RecordRouteSample(
        bulk_sample ? bulk_route_ : scatter_route_, /*via_tcp=*/true,
        tcp_bytes, tcp_secs, /*cold=*/tcp_cold);
  }
  return kOk;
}

bool TcpTransport::SendBarrierNotify(int target, int64_t seq, int round) {
  Peer& p = *peers_[target];
  Conn& c = *p.conns[0];
  std::lock_guard<std::mutex> lock(c.mu);
  // round rides in the offset field (unused by barrier frames).
  WireReq req{kMagic, kOpBarrier, rank_, 0, round, 0, seq};
  return EnsureConnected(p, c) == kOk &&
         FullSend(c.fd, &req, sizeof(req)) == 0;
}

int TcpTransport::Barrier(int64_t tag) {
  // Dissemination barrier: in round k every rank notifies
  // (rank + 2^k) % P (one-way, best-effort) and waits for the round-k
  // notify from (rank - 2^k) mod P — after ceil(log2 P) rounds each rank
  // has transitively heard from all others. O(P log P) total messages and
  // O(log P) serial latency instead of round 1's flat notify loop
  // (O(P^2) messages, O(P) serial sends under each conn mutex).
  //
  // Notify failures are not immediately fatal: the common benign case is
  // a peer that already passed this barrier and tore down — the
  // information it owed us was delivered before it exited. A peer that
  // truly died early can never notify us; the FAILURE DETECTOR surfaces
  // that in O(heartbeat): the per-round wait polls the store's suspect
  // oracle and aborts with kErrPeerLost naming the suspect the moment
  // any group member is declared dead (dissemination is transitive — a
  // dead member anywhere means this barrier can never complete). The
  // flat DDSTORE_BARRIER_TIMEOUT_S stays as the backstop for a peer
  // that is silent but never suspected (detector off, R=1 default):
  // that timeout keeps the old kErrTransport classification — slow is
  // not dead. (The reference has no failure detection at all, SURVEY
  // §5.)
  long timeout_s = 300;
  if (const char* env = ::getenv("DDSTORE_BARRIER_TIMEOUT_S")) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end != env && v > 0) timeout_s = v;
  }
  int rounds = 0;
  while ((1 << rounds) < world_) ++rounds;
  int64_t seq;
  {
    std::lock_guard<std::mutex> lock(barrier_mu_);
    seq = ++barrier_seq_;
  }
  const std::function<bool(int)> suspect = SuspectSnapshot();
  const bool traced = trace::Enabled();
  const uint64_t span = traced ? trace::NewSpan(rank_) : 0;
  if (traced)
    trace::Emit(trace::kBarrier, span, rank_, seq, tag, rounds);

  int result = kOk;
  for (int k = 0; k < rounds; ++k) {
    int to = (rank_ + (1 << k)) % world_;
    int from = (rank_ - (1 << k) + world_) % world_;
    if (!SendBarrierNotify(to, seq, k) && DebugOn())
      std::fprintf(stderr, "[dds r%d] barrier tag=%lld seq=%lld notify "
                   "r%d failed\n", rank_, static_cast<long long>(tag),
                   static_cast<long long>(seq), to);
    bool ok = false;
    int lost = -1;
    bool lost_final = false;
    {
      std::unique_lock<std::mutex> lock(barrier_mu_);
      const auto deadline = std::chrono::steady_clock::now() +
                            std::chrono::seconds(timeout_s);
      // Grace between "a member is suspected" and "abort": a member
      // that completed this barrier and tore down cleanly (the benign
      // staggered-teardown case) reads as dead to the detector, but
      // every notify it owed the group was already SENT — the wait
      // just needs the in-flight deliveries to land (milliseconds),
      // not a fabricated kErrPeerLost. A truly dead member's missing
      // notifies never arrive, so the grace only adds one bounded
      // beat to detection — still O(heartbeat), never O(timeout).
      constexpr auto kSuspectGrace = std::chrono::milliseconds(250);
      std::chrono::steady_clock::time_point lost_since;
      for (;;) {
        auto it = barrier_arrived_.find({seq, k});
        if (it != barrier_arrived_.end() && it->second >= 1) {
          ok = true;
          break;
        }
        // Suspect poll (lock-free atomic loads into the health
        // registry; barrier_mu_ is DDS_NO_BLOCKING and stays so):
        // ANY suspected member dooms the collective, not just this
        // round's sender — its notifies are transitive inputs to
        // every later round on some rank.
        if (suspect) {
          int s = -1;
          for (int t = 0; t < world_ && s < 0; ++t)
            if (t != rank_ && suspect(t)) s = t;
          const auto now = std::chrono::steady_clock::now();
          if (s < 0) {
            lost = -1;  // verdict cleared (peer healed): keep waiting
          } else if (s != lost) {
            lost = s;
            lost_since = now;
          } else if (now - lost_since >= kSuspectGrace) {
            lost_final = true;
            break;
          }
        }
        const auto now = std::chrono::steady_clock::now();
        if (now >= deadline) break;
        const auto slice = std::chrono::milliseconds(20);
        const auto left = deadline - now;
        barrier_cv_.wait_for(lock, left < slice ? left : slice);
      }
    }
    if (lost_final && lost >= 0) {
      // Detector abort: O(heartbeat) after the death, never
      // O(BARRIER_TIMEOUT). Name the suspect for the Python layer's
      // classify → elastic.recover handoff (same channel the data
      // path's ladder verdicts use) — no giveup counted: the budget
      // was not burned, the detector beat it.
      retry_.last_peer.store(lost);
      std::fprintf(stderr, "[dds r%d] barrier tag=%lld seq=%lld round "
                   "%d/%d aborted: peer r%d suspected dead (round "
                   "sender r%d)\n", rank_, static_cast<long long>(tag),
                   static_cast<long long>(seq), k, rounds, lost, from);
      if (traced) {
        trace::Emit(trace::kBarrierAbort, span, rank_, seq, k, lost);
        trace::ScopedSpan ss(span);
        trace::Flight(trace::kReasonBarrierAbort, rank_);
      }
      result = kErrPeerLost;
      break;
    }
    if (!ok) {
      std::fprintf(stderr, "[dds r%d] barrier tag=%lld seq=%lld round "
                   "%d/%d timed out after %lds waiting for r%d\n", rank_,
                   static_cast<long long>(tag),
                   static_cast<long long>(seq), k, rounds, timeout_s, from);
      if (traced) {
        trace::Emit(trace::kBarrierAbort, span, rank_, seq, k, -1);
        trace::ScopedSpan ss(span);
        trace::Flight(trace::kReasonBarrierAbort, rank_);
      }
      result = kErrTransport;
      break;
    }
  }
  if (traced && result == kOk)
    trace::Emit(trace::kBarrierDone, span, rank_, seq, tag, rounds);
  // Retire the seq win or lose: erase every entry at or below it and
  // raise the high-water mark so a straggler's late notify is dropped
  // instead of recreating (and leaking) an entry.
  std::lock_guard<std::mutex> lock(barrier_mu_);
  if (seq > retired_seq_) retired_seq_ = seq;
  barrier_arrived_.erase(
      barrier_arrived_.begin(),
      barrier_arrived_.upper_bound({seq, INT32_MAX}));
  return result;
}

}  // namespace dds
