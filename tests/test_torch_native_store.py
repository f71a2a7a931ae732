"""The port's store over its copy of the native core against the JAX
package's store: the same shards give byte-identical ``get``/
``get_batch``/``get_batch_async`` and the same error codes, over the
in-process transport (ThreadGroup ranks) and over TCP between spawned
processes that hold one store of each package (so the two native
libraries also live side by side in one process). Rank stamps pin which
owner served each row, with and without replica groups (``width``).
Exact equality throughout."""

import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

import ddstore_tpu as ref
from ddstore_tpu_torch import _build
from ddstore_tpu_torch import rendezvous as rdv
from ddstore_tpu_torch import store as tstore
from torch_workers import (read_all, run_threads, shard, spawn,
                           store_and_collectives_interleave, tcp_parity)

pytestmark = pytest.mark.tier1_required

NUM = 32


def _both(world, backend, width, tag, body):
    """Each thread rank builds a reference store and a port store over
    ThreadGroups of ``world`` and runs ``body(store, rank)`` on each;
    returns {"ref": [...], "port": [...]} by rank."""
    res = {}
    for key, mod, make in (("ref", ref, ref.DDStore),
                           ("port", rdv, tstore.DDStore)):
        def fn(r, mod=mod, make=make, key=key):
            g = mod.ThreadGroup(f"{tag}-{key}", r, world)
            with make(g, backend=backend, width=width) as s:
                return body(s, r)
        res[key] = run_threads(world, fn)
    return res


@pytest.mark.parametrize("backend", ["local", "tcp"])
@pytest.mark.parametrize("world", [1, 3])
def test_thread_ranks_read_the_same_bytes(backend, world):
    def body(s, r):
        s.add("v", shard(r, NUM))
        s.add("u8", np.full((NUM + r, 7, 3), r, np.uint8))
        got = read_all(s, "v", world, NUM, seed=r)
        got.append(s.get_batch("u8", np.arange(s.total_rows("u8"))
                               [::-1]).tobytes())
        return got, [s.total_rows("u8"), s.local_rows("u8"),
                     s.my_row_range("u8"), s.row_nbytes("u8"),
                     s.row_starts("u8").tolist(), s.variables()]

    res = _both(world, backend, None, f"bytes{backend}{world}", body)
    assert res["port"] == res["ref"]


BAD_READS = {
    "get past the shard": lambda s: s.get("x", 9, 2),
    "negative row": lambda s: s.get("x", -1),
    "row past the end": lambda s: s.get("x", 10, 0),
    "count past the end": lambda s: s.get("x", 0, 11),
    "batch past the end": lambda s: s.get_batch("x", [3, 10]),
    "negative batch row": lambda s: s.get_batch("x", [-1]),
    "async past the end": lambda s: s.get_batch_async("x", [0, 12]).wait(),
    "add twice": lambda s: s.add("x", np.zeros((10, 2), np.int64)),
    "update past the end": lambda s: s.update("x", np.zeros((3, 2)), 9),
    "ranks disagree on the shape": None,
}


@pytest.mark.parametrize("case", sorted(BAD_READS))
def test_bad_input_raises_the_same_code(case):
    if BAD_READS[case] is None:  # a collective refusal: two thread ranks
        def body(s, r):
            try:
                s.add("y", np.zeros((4, 2 + r), np.float32))
            except Exception as e:  # noqa: BLE001 — compared below
                return type(e).__name__, getattr(e, "code", None)
        res = _both(2, "local", None, "shape", body)
        assert res["port"] == res["ref"] == [("DDStoreError", -9)] * 2
        return
    codes = []
    for s, err in ((ref.DDStore(ref.SingleGroup(), backend="local"),
                    ref.DDStoreError),
                   (tstore.DDStore(), tstore.DDStoreError)):
        s.add("x", np.arange(20, dtype=np.int64).reshape(10, 2))
        with pytest.raises(err) as e:
            BAD_READS[case](s)
        codes.append(e.value.code)
        s.close()
    assert codes[0] == codes[1] < 0


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_rank_stamps_with_replica_groups(backend):
    world, width = 4, 2

    def body(s, r):
        assert (s.world, s.num_replicas) == (width, world // width)
        s.add("v", np.full((NUM, 5), s.rank + 1, np.float64))
        idx = np.arange(width * NUM)
        stamps = s.get_batch("v", idx)[:, 0]
        assert (stamps == idx // NUM + 1).all()
        return (s.rank, s.replica_id, s.world_group.rank,
                s.owner_of_rows("v", idx[::7]).tolist())

    res = _both(world, backend, width, f"width{backend}", body)
    assert res["port"] == res["ref"]
    assert [r[:3] for r in res["port"]] == [(0, 0, 0), (1, 0, 1),
                                            (0, 1, 2), (1, 1, 3)]


@pytest.mark.parametrize("after_close", ["nothing", "port_reused"])
def test_read_after_owner_close_fails_over(after_close, monkeypatch):
    # ROADMAP C: rank 1 of a replicated pair closes, and rank 0
    # reads rank 1's rows before any heartbeat (none runs). Its lanes to
    # rank 1 are dead, and the redial finds either no one at rank 1's
    # port, or (port_reused) another store that bound the port since,
    # holding a variable of the same name and shape filled with 7s. Both
    # times the rows come from rank 0's mirror of rank 1's shard, counted
    # as one failover read: the redial's kOpHello answer names another
    # instance than the one rank 0 met, and the transport refuses it.
    # (Without that check the redial took the other store's 7s with no
    # failover: the stress scenario's failover section under a concurrent
    # load, where another process's store took the freed port.) The
    # failed redial marks rank 1 suspected, so its ops are replanned as
    # a suspect skip; the second read skips it at once.
    for k, v in {"DDSTORE_REPLICATION": "2", "DDSTORE_HEARTBEAT_MS": "0",
                 "DDSTORE_RETRY_MAX": "2", "DDSTORE_OP_DEADLINE_S": "3",
                 "DDSTORE_CONNECT_TIMEOUT_S": "1",
                 "DDSTORE_READ_TIMEOUT_S": "2"}.items():
        monkeypatch.setenv(k, v)
    stores, closed = {}, threading.Barrier(2)

    def body(r):
        g = rdv.ThreadGroup(f"close-{after_close}", r, 2)
        s = stores[r] = tstore.DDStore(g, backend="tcp")
        s.add("v", np.full((NUM, 64), r + 1, np.float64))
        s.get_batch("v", np.arange(2 * NUM))  # rank 0 meets rank 1
        closed.wait()
        if r == 1:
            return None
        port = stores[1]._native.server_port
        stores[1]._native.close()
        other = None
        if after_close == "port_reused":
            os.environ["DDSTORE_REPLICATION"] = "1"
            other = tstore.DDStore(rdv.ThreadGroup(f"other-{after_close}",
                                                   0, 1), backend="tcp",
                                   port=port)
            other.add("v", np.full((NUM, 64), 7, np.float64))
            assert other._native.server_port == port
        seen = []
        for _ in range(2):
            rows = s.get_batch("v", np.arange(NUM, 2 * NUM))
            fo = s.failover_stats()
            seen.append((sorted(set(rows.ravel().tolist())),
                         fo["failover_reads"], fo["suspect_skips"]))
        if other is not None:
            other.close()
        return seen

    try:
        seen = run_threads(2, body)[0]
    finally:
        for s in stores.values():
            s._native.close()
    assert seen == [([2.0], 1, 1), ([2.0], 2, 2)]


@pytest.mark.parametrize("wire", ["tcp", "uring"])
def test_two_processes_over_tcp_match_reference(tmp_path, wire):
    ranks = spawn(2, tcp_parity, str(tmp_path), wire)
    for out in ranks:
        assert out["port"] == out["ref"]
    # each rank read the other's rows
    assert ranks[0]["port"][0] != ranks[1]["port"][0]


def test_store_reads_and_gloo_collectives_interleave(tmp_path):
    assert spawn(2, store_and_collectives_interleave, str(tmp_path)) == \
        [0, 0]


def test_library_exports_only_the_c_api():
    lib = _build.build()
    syms = subprocess.run(["nm", "-D", "--defined-only", lib],
                          capture_output=True, text=True, check=True)
    names = [ln.split()[-1] for ln in syms.stdout.splitlines() if ln]
    assert names and all(n.startswith("dds_") for n in names), \
        [n for n in names if not n.startswith("dds_")][:10]
    dyn = subprocess.run(["readelf", "--dyn-syms", "-W", lib],
                         capture_output=True, text=True, check=True)
    assert "UNIQUE" not in dyn.stdout


def _code(text):
    """C++ source without its comments or blank lines, each line
    right-stripped: what the compiler sees, up to layout."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            i = text.find("\n", i)
            i = n if i < 0 else i
        elif text.startswith("/*", i):
            i = text.index("*/", i) + 2
        elif c in "\"'":  # a string or char literal, escapes included
            j = i + 1
            while text[j] != c:
                j += 2 if text[j] == "\\" else 1
            out.append(text[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    lines = (ln.rstrip() for ln in "".join(out).splitlines())
    return [ln for ln in lines if ln]


# The port's departures from the reference core, by file: (the reference's
# code lines, the port's), each found once, applied in order. Three
# departures (ROADMAP C): the Conn::fd race's fix (TcpTransport::
# ReadVOnRetry's retry hook reads the lane's fd under its lock); the
# store's teardown stopping the serving side of its transport before it
# frees its variables (Transport::StopServing, called by Store::~Store
# after DrainAsync): a peer's read in that window got a well-formed
# "variable not found", which no replica router fails over, where it now
# finds a closed connection; and the connection identity check (kOpHello,
# TcpTransport::Introduce: every new data or control connection asks the
# peer for its instance id and refuses one other than the id met first,
# which UpdatePeer forgets), so that a redial to a closed peer's port
# that reaches another store fails over instead of reading that store's
# rows.
_PEER_CLOSES = ["  for (auto& p : peers_) {",
                "    if (!p) continue;",
                "    for (auto& c : p->conns)",
                "      if (c->fd >= 0) ::close(c->fd);",
                "  }",
                "  for (auto& pc : ping_conns_)",
                "    if (pc && pc->fd >= 0) ::close(pc->fd);"]
DEPARTURES = {
    "tcp_transport.cc": [
        (["        if (used->fd < 0)"],
         ["        bool closed;",
          "        {",
          "          std::lock_guard<std::mutex> lane(used->mu);",
          "          closed = used->fd < 0;",
          "        }",
          "        if (closed)"]),
        (_PEER_CLOSES + ["}"], ["}"]),
        (["TcpTransport::~TcpTransport() {",
          "  stopping_.store(true);"],
         ["TcpTransport::~TcpTransport() {",
          "  StopServing();"] + _PEER_CLOSES +
         ["}",
          "void TcpTransport::StopServing() {",
          "  if (stopping_.exchange(true)) return;"]),
        (["#include <cstring>"],
         ["#include <cstring>",
          "#include <random>"]),
        (["    ping_conns_[i] = std::make_unique<PingConn>();"],
         ["    ping_conns_[i] = std::make_unique<PingConn>();",
          "    ping_conns_[i]->target = i;"]),
        (["    p.hosts = hosts;",
          "    p.port = port;"],
         ["    p.hosts = hosts;",
          "    p.port = port;",
          "    p.instance.store(0);"]),
        (["      barrier_cv_.notify_all();",
          "      continue;",
          "    }"],
         ["      barrier_cv_.notify_all();",
          "      continue;",
          "    }",
          "    if (req.op == kOpHello) {",
          "      WireResp resp{kOk, 0, static_cast<int64_t>(instance_id_)};",
          "      if (FullSend(fd, &resp, sizeof(resp)) != 0) return;",
          "      continue;",
          "    }"]),
        (["        ::setsockopt(ufd, SOL_SOCKET, SO_RCVTIMEO, &utv, sizeof(utv));"],
         ["        ::setsockopt(ufd, SOL_SOCKET, SO_RCVTIMEO, &utv, sizeof(utv));",
          "        if (!Introduce(p, ufd)) {",
          "          ::close(ufd);",
          "          return kErrTransport;",
          "        }"]),
        (["  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));"],
         ["  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));",
          "  if (!Introduce(p, fd)) {",
          "    ::close(fd);",
          "    return kErrTransport;",
          "  }"]),
        (["  trace::Ev(trace::kLaneDial, rank_, c.idx, 0, 0);",
          "  return kOk;",
          "}"],
         ["  trace::Ev(trace::kLaneDial, rank_, c.idx, 0, 0);",
          "  return kOk;",
          "}",
          "uint64_t TcpTransport::NewInstanceId() {",
          "  std::random_device rd;",
          "  uint64_t id = (static_cast<uint64_t>(rd()) << 32) ^ rd() ^",
          "                static_cast<uint64_t>(",
          "                    std::chrono::steady_clock::now().time_since_epoch()",
          "                        .count());",
          "  return id != 0 ? id : 1;",
          "}",
          "bool TcpTransport::Introduce(Peer& p, int fd) {",
          "  WireReq req{kMagic, kOpHello, rank_, 0, 0, 0, 0};",
          "  WireResp resp;",
          "  if (FullSend(fd, &req, sizeof(req)) != 0 ||",
          "      FullRecv(fd, &resp, sizeof(resp)) != 0 || resp.status != kOk)",
          "    return false;",
          "  const uint64_t got = static_cast<uint64_t>(resp.nbytes);",
          "  uint64_t met = 0;",
          "  if (p.instance.compare_exchange_strong(met, got)) return true;",
          "  if (met != got && DebugOn())",
          "    std::fprintf(stderr, \"[dds r%d] a connection to a peer's port reached \"",
          "                 \"another store instance; refused\\n\", rank_);",
          "  return met == got;",
          "}"]),
        (["      SetNoDelay(fd);"],
         ["      SetNoDelay(fd);",
          "      timeval tv;",
          "      tv.tv_sec = timeout_ms / 1000;",
          "      tv.tv_usec = (timeout_ms % 1000) * 1000;",
          "      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));",
          "      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));",
          "      if (!Introduce(*peers_[pc.target], fd)) {",
          "        ::close(fd);",
          "        return -1;",
          "      }"])],
    "tcp_transport.h": [
        (["  ~TcpTransport() override;"],
         ["  ~TcpTransport() override;",
          "  void StopServing() override;"]),
        (["    std::vector<std::unique_ptr<Conn>> conns;"],
         ["    std::vector<std::unique_ptr<Conn>> conns;",
          "    std::atomic<uint64_t> instance{0};"]),
        (["  int EnsureConnected(Peer& p, Conn& c) DDS_REQUIRES(Conn::mu);"],
         ["  int EnsureConnected(Peer& p, Conn& c) DDS_REQUIRES(Conn::mu);",
          "  bool Introduce(Peer& p, int fd);",
          "  static uint64_t NewInstanceId();"]),
        (["  std::atomic<bool> stopping_{false};"],
         ["  std::atomic<bool> stopping_{false};",
          "  const uint64_t instance_id_ = NewInstanceId();"]),
        (["  struct PingConn {"],
         ["  struct PingConn {",
          "    int target = -1;"])],
    "store.h": [
        (["  virtual void SetSuspectOracle(std::function<bool(int)> oracle) {"],
         ["  virtual void StopServing() {}",
          "  virtual void SetSuspectOracle(std::function<bool(int)> oracle) {"])],
    "store.cc": [
        (["  DrainAsync();",
          "  FreeAll();"],
         ["  DrainAsync();",
          "  transport_->StopServing();",
          "  FreeAll();"])],
    "wire.h": [
        (["                     kOpAttach = 11, kOpDetach = 12, kOpLease = 13 };"],
         ["                     kOpAttach = 11, kOpDetach = 12, kOpLease = 13,",
          "                     kOpHello = 14 };"])]
}


def _depart(lines, f):
    """The reference's code lines of ``f`` with the port's departures."""
    for old, new in DEPARTURES.get(f, []):
        at = [i for i in range(len(lines)) if lines[i:i + len(old)] == old]
        assert len(at) == 1, (f, old, at)
        lines = lines[:at[0]] + new + lines[at[0] + len(old):]
    return lines


def test_native_sources_are_the_reference_copy():
    # the same code as the reference core and its demo, but for the
    # departures named in DEPARTURES; comments may differ
    here = os.path.dirname(os.path.abspath(__file__))
    ref_dir = os.path.join(os.path.dirname(here), "ddstore_tpu", "native")
    files = _build.SOURCES + _build.HEADERS + [_build.DEMO_SOURCE]
    for f in files:
        with open(os.path.join(ref_dir, f)) as a, \
                open(os.path.join(_build.NATIVE_DIR, f)) as b:
            assert _depart(_code(a.read()), f) == _code(b.read()), f
    assert sorted(os.listdir(_build.NATIVE_DIR)) == sorted(files)


def test_native_demo_runs_on_both_transports():
    # the reference's ctest (native/CMakeLists.txt:55, `dds_demo 4`):
    # four thread ranks on the local transport, then four over TCP on
    # localhost, each reading every peer's rank stamp
    demo = _build.build_demo()
    assert os.path.dirname(demo) == _build.BUILD_DIR
    res = subprocess.run([demo, "4"], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.splitlines() == ["local transport: ok",
                                       "tcp transport:   ok"]


def test_build_is_stale_aware(tmp_path, monkeypatch):
    src = tmp_path / "native"
    shutil.copytree(_build.NATIVE_DIR, src)
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    monkeypatch.setattr(_build, "LIB_PATH", str(lib))
    assert _build._stale()  # no library yet
    lib.write_bytes(b"")
    t = os.path.getmtime(src / "store.h")
    os.utime(lib, (t + 10, t + 10))
    assert not _build._stale()
    os.utime(src / "wire.h", (t + 20, t + 20))  # a header counts too
    assert _build._stale()


def test_demo_build_is_stale_aware(tmp_path, monkeypatch):
    # dds_demo is rebuilt when demo.cc or any unit of the core is newer;
    # the library does not look at demo.cc
    src = tmp_path / "native"
    shutil.copytree(_build.NATIVE_DIR, src)
    monkeypatch.setattr(_build, "NATIVE_DIR", str(src))
    exe, lib = tmp_path / "dds_demo", tmp_path / "lib.so"
    t = max(os.path.getmtime(f) for f in src.iterdir())
    for f in (exe, lib):
        f.write_bytes(b"")
        os.utime(f, (t + 10, t + 10))
    demo = [_build.DEMO_SOURCE]
    assert not _build._stale(str(exe), demo)
    os.utime(src / "demo.cc", (t + 20, t + 20))
    assert _build._stale(str(exe), demo)
    assert not _build._stale(str(lib))
    os.utime(exe, (t + 30, t + 30))
    os.utime(src / "store.cc", (t + 40, t + 40))
    assert _build._stale(str(exe), demo)


def _session_read(s):
    s.gateway_configure(enabled=1)
    with s.gateway_session("t") as sess:
        return sess.get("x", 1).tolist()


# Methods the port's store once refused until their modules were
# ported; each now runs, as on the JAX package's store.
SERVICES = {
    "spill_to_disk": lambda s, d: (
        os.path.basename(s.spill_to_disk("x", d)), s.var_tier("x")),
    "trace_summary": lambda s, d: sorted(s.trace_summary()),
    "metrics_summary": lambda s, d: {
        k: v["count"] for k, v in s.metrics_summary().items()},
    "cluster_metrics": lambda s, d: (len(s.cluster_metrics()[0]),
                                     s.cluster_metrics()[1]),
    "attach": lambda s, d: (type(s.attach("t")).__name__,
                            s.attach("t").get("x", 1).tolist()),
    "set_tenant_quota": lambda s, d: (
        s.set_tenant_quota("t", 1 << 20),
        s.tenant_stats()["t"]["quota_bytes"]),
    "gateway_session": lambda s, d: _session_read(s),
}


@pytest.mark.parametrize("method", sorted(SERVICES))
def test_later_slices_are_refused_by_name(method, tmp_path):
    """Each store service the port once refused, naming the slice that
    would bring it (hence the test's name), now runs on the port's store
    as on the JAX package's and leaves the store working."""
    got = {}
    for key, make in (("ref", ref.DDStore), ("port", tstore.DDStore)):
        with make(backend="local") as s:
            s.add("x", np.arange(6.0).reshape(3, 2))
            got[key] = SERVICES[method](s, str(tmp_path / key))
            assert s.get("x", 2)[0].tolist() == [4.0, 5.0]
    assert got["port"] == got["ref"]
