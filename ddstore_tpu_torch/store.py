"""Distributed sample store (the port of ``ddstore_tpu/store.py``).

Each member of the (replica-)group owns one shard of every registered
variable; the global row space is the concatenation of the shards in
group rank order, and any member reads any row by its global index. The
shards live in the port's copy of the native core (``native/``, through
:mod:`ddstore_tpu_torch.binding`): ``backend="local"`` for ranks that
are threads of one process, ``"tcp"`` (optionally over io_uring,
``DDSTORE_TRANSPORT=uring``) for ranks in separate processes or hosts.
The native core reads the same ``DDSTORE_*`` environment knobs as the
JAX package's, so one launch environment configures both.
"""

from __future__ import annotations

import os
import socket
import uuid
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .binding import (ERR_ADMISSION, ERR_CORRUPT, ERR_PEER_LOST,
                      DDStoreError, NativeStore)
from .rendezvous import (ProcessGroup, SingleGroup, ThreadGroup,
                         auto_group)

__all__ = ["AsyncBatchRead", "DDStore", "DDStoreError", "ProcessGroup"]


class AsyncBatchRead:
    """Handle to an in-flight background :meth:`DDStore.get_batch`.

    The read fills the preallocated ``out`` buffer on the native store's
    background pool; the handle keeps ``out`` (and the index array)
    alive until completion. ``wait()`` blocks (GIL released — the wait
    is a native condition variable), returns the filled buffer, and
    releases the native ticket; ``done()`` polls. There is no mid-flight
    cancel: ``release()`` on an unfinished read blocks until it
    completes — the teardown barrier that guarantees no worker is still
    writing into ``out`` when the caller drops it.
    """

    __slots__ = ("_native", "_ticket", "out", "_idx", "_released",
                 "_error", "done_mono_s")

    def __init__(self, native, ticket: int, out: np.ndarray,
                 idx: np.ndarray):
        self._native = native
        self._ticket = ticket
        self.out = out
        self._idx = idx  # starts are copied natively; held for debugging
        self._released = False
        self._error: Optional[int] = None  # the read's error code, if any
        #: completion time on the time.monotonic() clock, set by the
        #: first successful wait (readahead producer-idle accounting).
        self.done_mono_s: Optional[float] = None

    def done(self) -> bool:
        """Poll without blocking. Raises (and frees the ticket) if the
        read failed."""
        if self._released:
            if self._error is not None:
                raise DDStoreError(self._error, "get_batch_async")
            return True
        status, ts = self._native.async_wait(self._ticket, 0)
        if status < 0:
            self._error = status
            self.release()
            raise DDStoreError(status, "get_batch_async")
        if status == 1:
            self.done_mono_s = ts
        return status == 1

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the read completes; returns the filled buffer and
        releases the ticket. Raises TimeoutError if ``timeout`` (seconds)
        elapses first, DDStoreError if the read failed — including on a
        repeat call after a failure already surfaced (the buffer was
        never filled; returning it would look like success)."""
        if self._released:
            if self._error is not None:
                raise DDStoreError(self._error, "get_batch_async")
            return self.out
        ms = -1 if timeout is None else max(0, int(timeout * 1000))
        status, ts = self._native.async_wait(self._ticket, ms)
        if status == 0:
            raise TimeoutError(
                f"async get_batch not done after {timeout}s")
        if status < 0:
            self._error = status
        self.release()
        if status < 0:
            raise DDStoreError(status, "get_batch_async")
        self.done_mono_s = ts
        return self.out

    def release(self) -> None:
        """Free the native ticket, blocking until the read finishes (a
        worker must never be left writing into ``out``). Idempotent and
        non-raising — this is the teardown barrier."""
        if not self._released:
            self._released = True
            self._native.async_release(self._ticket)


def _check_varname(name: str) -> None:
    """Control characters are the native registry's namespace
    machinery (\\x01 mirrors, \\x02 tenant scopes, \\x03 snapshot
    views) — a user name carrying one could alias a hidden variable."""
    if not name:
        raise ValueError("variable name must be non-empty")
    if any(ord(c) < 0x20 for c in name):
        raise ValueError(f"variable name {name!r} contains control "
                         f"characters (reserved for the native "
                         f"namespace machinery)")


def _row_disp(sample_shape: Tuple[int, ...]) -> int:
    """Row displacement (elements per sample) — THE single derivation
    shared by add/init/add_mmap and the elastic rejoin path."""
    return int(np.prod(sample_shape, dtype=np.int64)) if sample_shape else 1


def _my_host() -> str:
    host = os.environ.get("DDSTORE_HOST")
    if host:
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _resolve_iface(token: str) -> str:
    """An IPv4 address passes through; anything else is treated as an
    interface name and resolved via SIOCGIFADDR (the reference's
    FABRIC_IFACE takes a fabric interface name the same way,
    common.cxx:32,54-59)."""
    try:
        socket.inet_aton(token)
        return token
    except OSError:
        pass
    import fcntl
    import struct
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        packed = struct.pack("256s", token.encode()[:255])
        try:
            addr = fcntl.ioctl(s.fileno(), 0x8915, packed)[20:24]  # SIOCGIFADDR
        except OSError as e:
            raise ValueError(f"DDSTORE_IFACES: cannot resolve interface "
                             f"{token!r}: {e}") from None
    return socket.inet_ntoa(addr)


def _my_ifaces() -> list:
    """Per-NIC addresses this rank advertises and binds outgoing
    connections to (DDSTORE_IFACES=addr-or-ifname[,addr-or-ifname...]).
    Empty list = single-NIC default (_my_host)."""
    env = os.environ.get("DDSTORE_IFACES", "")
    return [_resolve_iface(t.strip()) for t in env.split(",") if t.strip()]


class _VarMeta:
    __slots__ = ("dtype", "sample_shape", "disp", "all_nrows", "pinned",
                 "readonly", "tier")

    def __init__(self, dtype: np.dtype, sample_shape: Tuple[int, ...],
                 disp: int, all_nrows: Sequence[int],
                 pinned: Optional[np.ndarray] = None,
                 readonly: bool = False, tier: str = "hot"):
        self.dtype = dtype
        self.sample_shape = sample_shape
        self.disp = disp
        self.all_nrows = list(all_nrows)
        # With copy=False the native core borrows this buffer; holding it
        # here keeps it alive for the lifetime of the variable.
        self.pinned = pinned
        # True for read-only mmap backings: `update` must refuse rather
        # than memcpy into unwritable pages (SIGSEGV).
        self.readonly = readonly
        # Storage tier of the backing ("hot" = RAM/shm, "cold" =
        # file-backed mmap over NVMe page cache). Mirrored natively
        # (set_var_tier) for the cold_vars/cold_bytes gauges.
        self.tier = tier


class DDStore:
    """Distributed in-memory sample store over a process group.

    Each member of the (replica-)group owns one shard of every registered
    variable; the global row space is the concatenation of shards in group
    rank order; any member reads any row one-sidedly.

    Parameters
    ----------
    group: control-plane group (auto-detected if None).
    backend: "local" (in-process transport), "tcp" (DCN transport), or
        "auto" (local for single/thread groups, tcp otherwise).
    width: if set, split `group` into replica groups of `width` consecutive
        ranks; this store then spans only the caller's replica group (one
        full dataset copy per group, e.g. one store per host).
    copy: copy shards into store-owned memory at `add` (reference behavior)
        or borrow the caller's buffer (zero-copy; caller keeps it alive).
    epoch_collective: whether epoch_begin/end are collective fences
        or local no-ops. Default False: a fence per batch costs a round
        trip every step; use the explicit `barrier()` when needed.
    """

    def __init__(self, group: Optional[ProcessGroup] = None,
                 backend: str = "auto", width: Optional[int] = None,
                 copy: bool = True, epoch_collective: bool = False,
                 port: int = 0):
        self.world_group = group if group is not None else auto_group()
        if width is not None and width > 0:
            self.replica_id = self.world_group.rank // width
            self.group = self.world_group.split(self.replica_id)
            self.num_replicas = (self.world_group.size + width - 1) // width
        else:
            self.replica_id = 0
            self.group = self.world_group
            self.num_replicas = 1

        if backend == "auto":
            # Env override first (the reference selects its backend the
            # same way: DDSTORE_METHOD, distdataset.py:32), then by
            # group kind.
            backend = os.environ.get("DDSTORE_BACKEND", "").strip() \
                or ("local" if isinstance(self.group,
                                          (SingleGroup, ThreadGroup))
                    else "tcp")
        if backend == "local" and self.group.size > 1 and not isinstance(
                self.group, (SingleGroup, ThreadGroup)):
            # The local backend's registry is per-process; with ranks in
            # separate processes every rank would wait forever for peers
            # that can never join its registry. Size-1 groups of any kind
            # are trivially process-local.
            raise ValueError(
                "backend 'local' requires all ranks in one process "
                f"(got {type(self.group).__name__} of size "
                f"{self.group.size}); use 'tcp'")
        self.backend = backend
        self.copy = copy
        self._meta: Dict[str, _VarMeta] = {}
        # One metadata registry per NAMED tenant, shared by every handle
        # of that tenant (see tenant/handle.py): a second attach — a
        # snapshot reader included — must resolve the tenant's variables.
        self._tenant_meta: Dict[str, Dict[str, _VarMeta]] = {}
        self._barrier_tag = 1 << 32  # distinct from epoch tags
        self._closed = False

        rank, world = self.group.rank, self.group.size
        # Elastic-recovery bookkeeping (ddstore_tpu_torch.elastic): which
        # endpoint each peer currently lives at, what this rank
        # advertises, and how many recovery generations have committed.
        self._advertised = None
        self._endpoints = None
        self._generation = 0
        # Peer-topology listeners (see add_peer_listener): the cost-model
        # scheduler replans when elastic recovery swaps an endpoint OR
        # the heartbeat detector suspects a peer (check_health).
        self._peer_listeners = []
        # Suspect view already delivered to listeners (check_health
        # fires them only on CHANGE).
        self._known_suspects = frozenset()
        if backend == "local":
            gid = self.group.broadcast(uuid.uuid4().hex)
            self._gid = gid
            self._native = NativeStore.create_local(gid, rank, world)
        elif backend == "tcp":
            self._gid = None
            # DDSTORE_TRANSPORT=uring swaps the per-lane wire loop for
            # the io_uring batch backend (one io_uring_enter per frame
            # burst). Everything else — peers, lanes, CMA routing,
            # faults, failover, gateway — is the inherited TcpTransport
            # machinery, and on an io_uring-less kernel the handle
            # still constructs and serves plain TCP (uring_state()==0,
            # uring_reason() says why). Unset/"tcp" is pinned
            # byte-identical to the pre-uring tree.
            wire = os.environ.get("DDSTORE_TRANSPORT", "").strip().lower()
            if wire == "uring":
                self._native = NativeStore.create_uring(rank, world, port)
            elif wire in ("", "tcp"):
                self._native = NativeStore.create_tcp(rank, world, port)
            else:
                raise ValueError(
                    f"DDSTORE_TRANSPORT={wire!r}: expected 'tcp' or "
                    "'uring' (CMA is a per-read route, not a backend)")
            # Multi-NIC: advertise every DDSTORE_IFACES address (the
            # server listens on INADDR_ANY, so one port serves all NICs)
            # and bind outgoing pool connections to them round-robin.
            ifaces = _my_ifaces()
            advertised = ",".join(ifaces) if ifaces else _my_host()
            endpoints = self.group.allgather(
                (advertised, self._native.server_port))
            hosts = [h for h, _ in endpoints]
            ports = [p for _, p in endpoints]
            self._native.set_peers(hosts, ports)
            if ifaces:
                self._native.set_ifaces(ifaces)
            self._advertised = advertised
            self._endpoints = [tuple(e) for e in endpoints]
        else:
            raise ValueError(f"unknown backend: {backend}")
        self._native.set_epoch_collective(epoch_collective)

    # -- registration ------------------------------------------------------

    def add(self, name: str, arr: np.ndarray,
            copy: Optional[bool] = None, readonly: bool = False) -> None:
        """Register this rank's shard. ``arr`` is sample-major: shape
        ``(nrows, *sample_shape)``; one global row == one sample (fixing the
        reference adapter's flattened-blob indexing trap,
        distdataset.py:63,84 where ``disp=1`` made row != sample).
        ``copy`` overrides the store default (False borrows the buffer —
        how mmap-backed tiering serves from page cache)."""
        _check_varname(name)
        copy = self.copy if copy is None else copy
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 0:
            raise ValueError("shard must have a leading sample dimension")
        nrows = arr.shape[0]
        sample_shape = tuple(arr.shape[1:])
        disp = _row_disp(sample_shape)
        metas = self.group.allgather(
            (nrows, arr.dtype.str, sample_shape))
        shapes = {(d, s) for _, d, s in metas}
        if len(shapes) != 1:
            raise DDStoreError(-9, f"add({name}): ranks disagree on "
                                   f"dtype/sample shape: {sorted(shapes)}")
        all_nrows = [m[0] for m in metas]
        self._native.add(self._wname(name), arr, all_nrows, copy=copy)
        # A borrowed buffer the caller can't write (e.g. a frombuffer
        # view over an immutable bytes object) must refuse update() with
        # a DDStoreError, not let the native memcpy SIGSEGV on the
        # unwritable pages.
        if not copy and not arr.flags.writeable:
            readonly = True
        self._meta[name] = _VarMeta(arr.dtype, sample_shape, disp, all_nrows,
                                    pinned=None if copy else arr,
                                    readonly=readonly)
        # `add` is collective in the reference (MPI_Win_create,
        # ddstore.hpp:56-62); completing it with a barrier gives the same
        # guarantee: once any rank returns, every shard is readable.
        self._finish_collective_add(name)

    def init(self, name: str, nrows: int, sample_shape: Tuple[int, ...],
             dtype) -> None:
        """Register a zero-filled shard for deferred population (reference
        ``init``, pyddstore.pyx:112-113)."""
        _check_varname(name)
        dtype = np.dtype(dtype)
        disp = _row_disp(tuple(sample_shape))
        metas = self.group.allgather((int(nrows), dtype.str,
                                      tuple(sample_shape)))
        shapes = {(d, s) for _, d, s in metas}
        if len(shapes) != 1:
            raise DDStoreError(-9, f"init({name}): ranks disagree")
        all_nrows = [m[0] for m in metas]
        self._native.init(self._wname(name), nrows, disp,
                          dtype.itemsize, all_nrows)
        self._meta[name] = _VarMeta(dtype, tuple(sample_shape), disp,
                                    all_nrows)
        self._finish_collective_add(name)

    def _finish_collective_add(self, name: str) -> None:
        """The barrier → replicate → barrier tail of ``add``/``init``,
        made CRASH-CONSISTENT: a peer DEATH mid-fence (the barrier
        aborts with the classified ``ERR_PEER_LOST``, in O(heartbeat)
        when the detector is on) rolls the LOCAL registration back —
        native variable freed, metadata dropped — before re-raising.
        In the common case every survivor's oracle converges on the
        same dead member and all of them abort the same fence, so a
        subsequent ``elastic.recover`` + retried ``add`` finds the
        clean pre-add state everywhere — no half-registered variable
        poisoning later collectives with ``ERR_EXISTS`` on some ranks
        only. The abort is not GUARANTEED unanimous (a victim that
        partially disseminated its barrier notifies can let one
        survivor complete the fence others aborted — the same window
        the fence state machine heals with ``fence_reset`` at
        recovery); a retried ``add`` that hits ``ERR_EXISTS`` on such
        a completed rank is realigned by a collective ``free(name)`` +
        re-add. A plain barrier TIMEOUT (``ERR_TRANSPORT``, no
        suspect) deliberately does NOT unwind: a slow-but-alive peer
        may have completed the fence and kept the variable, and a
        one-sided rollback would widen exactly that divergence (the
        pre-hardening behavior — keep the registration, surface the
        error)."""
        try:
            self.barrier()
            self._replicate_after_add(name)
        except DDStoreError as e:
            if e.code == ERR_PEER_LOST:
                try:
                    self._native.free_var(self._wname(name))
                except DDStoreError:
                    pass  # best-effort rollback; the raise is the news
                self._meta.pop(name, None)
            raise

    def _replicate_after_add(self, name: str) -> None:
        """R-way shard replication (``DDSTORE_REPLICATION``): after the
        registration barrier every rank pulls read-only mirrors of the
        next R-1 ranks' shards (chain placement), then a second barrier
        makes the replica chain live before any read can need it.
        No-op (and byte-identical to the pre-replication tree) at the
        default R=1. A failed mirror pull is DEGRADED COVERAGE, not a
        failed add: raising here would skip the trailing barrier and
        stall every healthy rank in it — the replica router already
        tolerates a missing mirror (next holder / classified loss), and
        ``refresh_mirrors`` or the next epoch fence retries the pull."""
        if self.replication > 1 and self.world > 1:
            try:
                self._native.replicate(self._wname(name))
            except DDStoreError as e:
                import warnings

                warnings.warn(
                    f"add({name}): mirror replication incomplete on "
                    f"rank {self.rank} ({e}); reads stay correct, "
                    f"failover coverage is reduced until the next "
                    f"refresh", RuntimeWarning, stacklevel=3)
            self.barrier()

    def update(self, name: str, arr: np.ndarray, row_offset: int = 0) -> None:
        """Overwrite local rows [row_offset, row_offset+len(arr)) (reference
        ``update``, pyddstore.pyx:115-131 — bounds-checked here)."""
        m = self._require(name)
        if m.readonly:
            raise DDStoreError(
                -1, f"update({name}): refused — the shard is a "
                    f"read-only {m.tier}-tier file-backed mapping "
                    f"(registered via add_file/add_mmap/spill_to_disk "
                    f"with copy=False); re-register with mode='r+' or "
                    f"tier='hot' to keep update() usable")
        arr = np.ascontiguousarray(arr, dtype=m.dtype)
        if tuple(arr.shape[1:]) != m.sample_shape:
            raise ValueError(
                f"update({name}): sample shape {tuple(arr.shape[1:])} != "
                f"registered {m.sample_shape}")
        self._native.update(self._wname(name), arr, row_offset)

    # -- reads -------------------------------------------------------------

    def get(self, name: str, start: int, count: int = 1,
            out: Optional[np.ndarray] = None) -> np.ndarray:
        """Read `count` consecutive global rows starting at `start`. The
        range must lie within one rank's shard (single-peer read, as the
        reference enforces, ddstore.hpp:210-214); use :meth:`get_batch` for
        arbitrary index sets."""
        m = self._require(name)
        out = self._check_out(name, m, out, count)
        try:
            self._native.get(self._rname(name), out, start, count,
                             tenant=self._read_tenant())
        except DDStoreError as e:
            raise self._classify(e, name,
                                 np.arange(start, start + count)) from None
        return out

    def get_batch(self, name: str, indices, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Read arbitrary global rows, coalesced per owner and fetched from
        distinct peers in parallel — the batched fetch path the reference
        lacks (it issues one blocking get per sample, SURVEY §3.2)."""
        m = self._require(name)
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        out = self._check_out(name, m, out, len(idx))
        try:
            self._native.get_batch(self._rname(name), out, idx,
                                   tenant=self._read_tenant())
        except DDStoreError as e:
            raise self._classify(e, name, idx) from None
        return out

    def get_batch_async(self, name: str, indices,
                        out: Optional[np.ndarray] = None) -> AsyncBatchRead:
        """Issue :meth:`get_batch` on the native background pool and
        return immediately with an :class:`AsyncBatchRead` handle — the
        epoch-readahead engine keeps the next window's bulk fetch in
        flight this way while the current window is consumed. ``out``
        must not be read (or dropped) until the handle completes."""
        m = self._require(name)
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        out = self._check_out(name, m, out, len(idx))
        ticket = self._native.get_batch_async(self._rname(name), out, idx,
                                              tenant=self._read_tenant())
        return AsyncBatchRead(self._native, ticket, out, idx)

    def read_runs_async(self, name: str, out: np.ndarray, targets,
                        src_offsets, dst_offsets,
                        nbytes) -> AsyncBatchRead:
        """Issue pre-coalesced per-peer runs (byte spans) in the
        background — the readahead window fast path: the window planner
        already sorted/deduped/coalesced its rows, so the native side
        executes O(runs) work instead of re-planning O(rows). Run i
        reads ``nbytes[i]`` at byte offset ``src_offsets[i]`` of
        ``targets[i]``'s shard into ``out`` at byte ``dst_offsets[i]``.
        Same completion contract as :meth:`get_batch_async`."""
        self._require(name)
        ticket = self._native.read_runs_async(
            self._rname(name), out, targets, src_offsets, dst_offsets,
            nbytes, tenant=self._read_tenant())
        return AsyncBatchRead(self._native, ticket, out, None)

    def async_pending(self) -> int:
        """In-flight / unreleased async reads (0 after clean teardown)."""
        return self._native.async_pending

    def _classify(self, e: DDStoreError, name: str,
                  idx: np.ndarray) -> DDStoreError:
        """Re-raise helper for failed reads: a permanent owner loss
        (``ERR_PEER_LOST`` — the bounded signal the native retry layer
        emits when its budget exhausts against one peer) is augmented
        with WHICH owner died and WHICH requested rows were lost, so the
        caller can hand exactly that to ``elastic.recover``; a data
        integrity failure (``ERR_CORRUPT``) is augmented the same way —
        which owner's bytes disagree with the published checksums and
        which requested rows are affected (the flight recorder already
        dumped; nothing died, so elastic.recover is NOT the next step —
        inspect/rebuild the named shard). Everything else passes
        through unchanged."""
        if e.code == ERR_CORRUPT:
            peer = int(self.integrity_stats().get("last_corrupt_peer",
                                                  -1))
            bad = idx
            try:
                if peer >= 0:
                    owners = self.owner_of_rows(name, idx)
                    bad = idx[owners == peer]
            except Exception:  # noqa: BLE001 — diagnostics must not mask e
                pass
            preview = ", ".join(str(int(r)) for r in bad[:4])
            more = "..." if len(bad) > 4 else ""
            holders = (f"and every readable mirror holder "
                       if self.replication > 1 else "")
            return DDStoreError(
                e.code,
                f"{name}: owner rank {peer} {holders}serve(s) bytes "
                f"disagreeing with the published checksums at a stable "
                f"content version; {len(bad)} requested rows affected "
                f"(rows {preview}{more}) — the delivered batch was NOT "
                f"silently used; inspect trace_flight_dump() and the "
                f"named shard")
        if e.code == ERR_ADMISSION:
            # Defer-not-peer-lost: NOTHING died — the serving gateway
            # refused admission to protect another tenant's SLO (or the
            # rank is draining). Surface the retry-after hint so callers
            # (GatewaySession, the loader's degraded ladder) back off
            # with seeded jitter instead of escalating to elastic.recover.
            try:
                hint = int(self._native.gateway_stats()
                           .get("last_retry_after_ms", 0))
            except Exception:  # noqa: BLE001 — diagnostics must not mask e
                hint = 0
            err = DDStoreError(
                e.code,
                f"{name}: admission refused by the serving gateway "
                f"(defer, not peer-lost — no rows were lost); retry "
                f"after ~{hint} ms with jittered backoff")
            err.retry_after_ms = hint
            return err
        if e.code != ERR_PEER_LOST:
            return e
        peer = int(self._native.fault_stats().get("last_error_peer", -1))
        lost = idx
        try:
            if peer >= 0:
                owners = self.owner_of_rows(name, idx)
                lost = idx[owners == peer]
        except Exception:  # noqa: BLE001 — diagnostics must not mask e
            pass
        preview = ", ".join(str(int(r)) for r in lost[:4])
        more = "..." if len(lost) > 4 else ""
        r = self.replication
        how = (f"owner rank {peer} and all {r - 1} mirror holder(s) "
               f"unreachable" if r > 1
               else f"owner rank {peer} unreachable after bounded "
                    f"retries")
        err = DDStoreError(
            e.code,
            f"{name}: {how}; {len(lost)} requested rows lost "
            f"(rows {preview}{more}) — invoke elastic.recover")
        return err

    @staticmethod
    def _check_out(name: str, m: "_VarMeta", out: Optional[np.ndarray],
                   count: int) -> np.ndarray:
        want = (count,) + m.sample_shape
        if out is None:
            return np.empty(want, dtype=m.dtype)
        # The native core writes count*row_bytes blindly; a wrong dtype or
        # shape here would be heap corruption, so reject rather than coerce.
        if out.dtype != m.dtype or tuple(out.shape) != want:
            raise ValueError(
                f"get({name}): out must be {want} {m.dtype}, got "
                f"{tuple(out.shape)} {out.dtype}")
        return out

    # -- disk / NVMe tiering ----------------------------------------------
    #
    # Shards larger than host RAM: register an mmap-backed buffer with
    # copy=False — the store serves one-sided reads straight out of the OS
    # page cache, so the kernel tiers hot rows in RAM and cold rows on
    # NVMe. The reference holds everything in MPI_Alloc_mem'd RAM and
    # doubles it at registration (ddstore.hpp:43-49); this is the
    # capability BASELINE.md's billion-edge / host↔NVMe config asks for.

    def add_file(self, name: str, path: str, dtype,
                 sample_shape: Tuple[int, ...], tier: str = "cold",
                 mode: str = "r") -> None:
        """Register a file-backed shard (collective) — the first-class
        cold-tier entry point. ``nrows`` is inferred from the file
        size.

        ``tier="cold"`` (the default) registers an ``np.memmap`` with
        ``copy=False``: the store serves one-sided reads straight out
        of the OS page cache, so the kernel tiers hot rows in RAM and
        cold rows on NVMe — the servable dataset per node scales with
        the NVMe/RAM ratio, not RAM. Every serving leg (local memcpy,
        /dev/shm CMA, TCP iovec streaming), replication mirrors,
        integrity sums and tenant quotas work on a cold shard
        unchanged; pair it with ``DDSTORE_TIER_CACHE_BYTES`` so the
        readahead planner's window row lists prefetch upcoming cold
        rows into the RAM hot-row cache. ``mode="r"`` shards refuse
        ``update()`` (the error names the tier); ``mode="r+"`` keeps
        it usable. ``tier="hot"`` loads the file INTO RAM instead
        (a store-owned copy — the pre-tiering behavior for data that
        fits)."""
        if tier not in ("cold", "hot"):
            raise ValueError(f"add_file({name}): tier must be 'cold' or "
                             f"'hot', got {tier!r}")
        dtype = np.dtype(dtype)
        disp = _row_disp(tuple(sample_shape))
        row_bytes = disp * dtype.itemsize
        size = os.path.getsize(path)
        if size % row_bytes:
            raise ValueError(f"add_file({name}): {path} size {size} is not "
                             f"a multiple of row bytes {row_bytes}")
        nrows = size // row_bytes
        if tier == "hot":
            arr = np.fromfile(path, dtype=dtype).reshape(
                (nrows,) + tuple(sample_shape))
            self.add(name, arr, copy=True)
            return
        if nrows:
            arr = np.memmap(path, dtype=dtype, mode=mode,
                            shape=(nrows,) + tuple(sample_shape))
        else:  # a rank may own zero rows; mmap of an empty file is invalid
            arr = np.empty((0,) + tuple(sample_shape), dtype)
        self.add(name, arr, copy=False, readonly=(mode == "r"))
        self._meta[name].tier = "cold"
        self._native.set_var_tier(self._wname(name), 1)
        # O_DIRECT serving (DDSTORE_URING_COLD): readonly cold shards
        # only — a writable mmap's updates would be invisible to
        # page-cache-bypassing direct reads. Refusal (no io_uring, fs
        # without O_DIRECT) keeps the var on the mmap path silently.
        if mode == "r" and nrows and self._cold_direct_wanted():
            self._native.set_var_file(self._wname(name), path)

    def _cold_direct_wanted(self) -> bool:
        """DDSTORE_URING_COLD gate for O_DIRECT cold-tier serving:
        1/0 force it on/off; ``auto`` (default) follows the wire
        backend — on exactly when this store's io_uring transport
        engaged (same kernel verdict; the cold ring reuses the same
        probe). Registration itself may still refuse (filesystem
        without O_DIRECT) — that is per-var and silent."""
        v = os.environ.get("DDSTORE_URING_COLD", "auto").strip().lower()
        if v in ("1", "on", "true"):
            return True
        if v in ("0", "off", "false"):
            return False
        return self.backend == "tcp" and self._native.uring_state() == 1

    def add_mmap(self, name: str, path: str, dtype,
                 sample_shape: Tuple[int, ...], mode: str = "r") -> None:
        """Register a file-backed shard (collective) — the historical
        alias of :meth:`add_file` with ``tier="cold"``."""
        self.add_file(name, path, dtype, sample_shape, tier="cold",
                      mode=mode)

    def spill_to_disk(self, name: str, directory: str,
                      chunk_rows: int = 65536) -> str:
        """Move this variable's local shard from RAM to a file-backed
        mapping (collective: every rank spills its own shard). Remote
        readers are unaffected: the shard is first written to disk, then
        the backing memory is swapped to the mmap ATOMICALLY under the
        native store's exclusive lock (``Rebind``) — a concurrent remote
        read is served from either the old RAM buffer or the new page
        cache mapping, both holding identical bytes; there is no window
        where the variable is missing (the free+re-add alternative had
        one). The on-disk artifact is a checkpoint shard
        (``utils.save_shard`` format, JSON sidecar included), so a
        spilled variable restores across restarts with
        ``utils.load_shard(..., mmap=True)``."""
        from .utils.checkpoint import save_shard

        m = self._require(name)
        path = save_shard(self, name, directory, chunk_rows=chunk_rows)
        nrows = m.all_nrows[self.rank]
        if nrows:
            arr = np.memmap(path, dtype=m.dtype, mode="r",
                            shape=(nrows,) + tuple(m.sample_shape))
        else:  # mmap of an empty file is invalid
            arr = np.empty((0,) + tuple(m.sample_shape), m.dtype)
        self._native.rebind(self._wname(name), arr)
        m.pinned = arr  # keep the mapping alive; old pin (if any) drops
        m.readonly = True
        m.tier = "cold"
        self._native.set_var_tier(self._wname(name), 1)
        # Spilled shards are readonly by construction — eligible for
        # O_DIRECT serving under the same gate as add_file.
        if nrows and self._cold_direct_wanted():
            self._native.set_var_file(self._wname(name), path)
        # Collective completion: once any rank returns, every rank's swap
        # is done (mirrors add()'s barrier guarantee).
        self.barrier()
        return path

    # -- ragged variables --------------------------------------------------
    #
    # Variable-length samples (graphs, token sequences), which the
    # original DDStore cannot hold (its rows are fixed-width, a uniform
    # `disp` enforced via MPI_Allreduce MAX). A ragged variable is stored
    # as two fixed-width variables:
    #   {name}/values — the flattened elements (one global row == one
    #       element of shape item_shape), and
    #   {name}/index  — per-sample (global_values_start, length) int64.
    # Every sample's elements lie wholly inside its owner's values shard,
    # so a sample read is a single-peer contiguous read, and batched reads
    # coalesce per owner exactly like fixed-width get_batch.

    def add_ragged(self, name: str, samples: Sequence[np.ndarray]) -> None:
        """Register this rank's ragged shard: ``samples[i]`` has shape
        ``(len_i, *item_shape)`` with ``len_i`` varying per sample."""
        if f"{name}/values" in self._meta:
            raise DDStoreError(-8, f"add_ragged({name}): already exists")
        samples = [np.ascontiguousarray(s) for s in samples]
        if samples:
            item_shape = tuple(samples[0].shape[1:])
            dtype = samples[0].dtype
            for s in samples:
                if tuple(s.shape[1:]) != item_shape or s.dtype != dtype:
                    raise ValueError(
                        f"add_ragged({name}): inconsistent item shape/dtype")
            flat = np.concatenate(samples, axis=0)
        else:  # a rank may hold zero samples
            item_shape, dtype = (), np.dtype(np.float32)
            flat = np.empty((0,), dtype)
        # Ranks with no samples can't infer item shape/dtype locally; adopt
        # the group consensus (add() below still enforces agreement).
        metas = self.group.allgather((len(samples), dtype.str, item_shape))
        nonempty = [(d, s) for n, d, s in metas if n > 0]
        if not samples and nonempty:
            dtype = np.dtype(nonempty[0][0])
            item_shape = nonempty[0][1]
            flat = np.empty((0,) + item_shape, dtype)
        lengths = np.array([s.shape[0] for s in samples], np.int64)
        self.add(f"{name}/values", flat)
        begin, _ = self.my_row_range(f"{name}/values")
        starts = begin + np.concatenate(([0], np.cumsum(lengths)[:-1]))\
            if len(lengths) else np.empty((0,), np.int64)
        index = np.stack([starts, lengths], axis=1) if len(lengths) \
            else np.empty((0, 2), np.int64)
        try:
            self.add(f"{name}/index", index.astype(np.int64))
        except DDStoreError as e:
            # Ragged-level crash consistency: each add() already
            # unwinds ITSELF on a death mid-fence, but a death during
            # the SECOND add would otherwise leave the values half of
            # the pair registered — a partial ragged variable
            # is_ragged() rejects yet whose shard RAM lingers.
            if e.code == ERR_PEER_LOST:
                try:
                    self._native.free_var(self._wname(f"{name}/values"))
                except DDStoreError:
                    pass  # best-effort; the raise below is the news
                self._meta.pop(f"{name}/values", None)
            raise

    def is_ragged(self, name: str) -> bool:
        return f"{name}/index" in self._meta and f"{name}/values" in self._meta

    def ragged_total(self, name: str) -> int:
        """Number of ragged samples across all ranks."""
        return self.total_rows(f"{name}/index")

    def get_ragged(self, name: str, idx: int) -> np.ndarray:
        """Read one variable-length sample (shape ``(len, *item_shape)``)."""
        start, length = self.get(f"{name}/index", idx)[0]
        m = self._require(f"{name}/values")
        out = np.empty((int(length),) + m.sample_shape, m.dtype)
        if length:
            self._native.get(self._rname(f"{name}/values"), out,
                             int(start), int(length),
                             tenant=self._read_tenant())
        return out

    def get_ragged_batch(self, name: str, indices):
        """Read many variable-length samples in two batched rounds (index
        rows, then all element spans coalesced per owner). Returns
        ``(values, lengths)`` where ``values`` is the concatenation of the
        requested samples in request order — the natural input to
        pack-and-pad batching for XLA's static shapes."""
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        index = self.get_batch(f"{name}/index", idx)
        starts, lengths = index[:, 0], index[:, 1]
        m = self._require(f"{name}/values")
        if len(idx) == 0:
            return (np.empty((0,) + m.sample_shape, m.dtype),
                    np.empty((0,), np.int64))
        # Element row ids: concatenated aranges, built vectorized (this is
        # the hot fetch path — a Python loop over thousands of small
        # samples would dominate latency). Adjacent elements of one sample
        # coalesce into one contiguous run in the native core.
        total = int(lengths.sum())
        prefix = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        rows = (np.repeat(starts - prefix, lengths)
                + np.arange(total, dtype=np.int64))
        values = np.empty((total,) + m.sample_shape, m.dtype)
        if total:
            self._native.get_batch(self._rname(f"{name}/values"),
                                   values, rows,
                                   tenant=self._read_tenant())
        return values, lengths.astype(np.int64)

    # -- metadata ----------------------------------------------------------

    def query(self, name: str) -> dict:
        info = self._native.query(self._rname(name))
        m = self._require(name)
        info["dtype"] = m.dtype
        info["sample_shape"] = m.sample_shape
        return info

    def total_rows(self, name: str) -> int:
        return int(self._native.query(self._rname(name))["total_rows"])

    def local_rows(self, name: str) -> int:
        return int(self._native.query(self._rname(name))["local_rows"])

    def my_row_range(self, name: str) -> Tuple[int, int]:
        """Global [begin, end) owned by this rank."""
        m = self._require(name)
        begin = int(sum(m.all_nrows[: self.rank]))
        return begin, begin + m.all_nrows[self.rank]

    def row_starts(self, name: str) -> np.ndarray:
        """Cumulative shard starts: ``row_starts[r]`` is the first global
        row owned by rank r (length world+1; the trailing entry is
        ``total_rows``). THE owner table the scatter-read planner
        binary-searches in the native core, surfaced to Python for the
        device-collective fetch planner."""
        m = self._require(name)
        return np.concatenate(
            ([0], np.cumsum(np.asarray(m.all_nrows, np.int64))))

    def owner_of_rows(self, name: str, indices) -> np.ndarray:
        """Owning group rank of each global row index (vectorized
        binary search over :meth:`row_starts`)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
        starts = self.row_starts(name)
        if idx.size and (idx.min() < 0 or idx.max() >= starts[-1]):
            raise IndexError(f"owner_of_rows({name}): index out of "
                             f"range [0, {int(starts[-1])})")
        return np.searchsorted(starts, idx, side="right") - 1

    def row_nbytes(self, name: str) -> int:
        """Bytes of one sample row (the bytes-moved ledger unit)."""
        m = self._require(name)
        return int(m.disp * m.dtype.itemsize)

    def sample_spec(self, name: str) -> Tuple[Tuple[int, ...], np.dtype]:
        """``(sample_shape, dtype)`` of a variable's rows (what a caller
        preallocates to pass as ``out``)."""
        m = self._require(name)
        return m.sample_shape, m.dtype

    def variables(self):
        return sorted(self._meta)

    # -- epochs / sync -----------------------------------------------------

    def _classify_collective(self, e: DDStoreError,
                             what: str) -> DDStoreError:
        """Collective-failure analogue of :meth:`_classify`: a barrier
        or epoch fence aborted by the failure detector surfaces
        ``ERR_PEER_LOST`` naming the dead member (the native side
        already rolled the fence state machine back and fed the suspect
        registry), and the fix is the same elastic.recover handoff a
        lost read gets. A plain timeout (no suspect) passes through as
        the generic transport error — slow is not dead."""
        if e.code != ERR_PEER_LOST:
            return e
        peer = int(self._native.fault_stats().get("last_error_peer", -1))
        suspects = self.suspected_peers()
        return DDStoreError(
            e.code,
            f"{what}: peer rank {peer} died mid-collective (suspected: "
            f"{suspects}) — detected by the failure detector in "
            f"O(heartbeat), not a {what} timeout; the collective was "
            f"rolled back to a recoverable state. Invoke "
            f"elastic.recover, then re-enter the epoch/collective")

    def epoch_begin(self) -> None:
        try:
            self._native.epoch_begin()
        except DDStoreError as e:
            raise self._classify_collective(e, "epoch_begin") from None

    def epoch_end(self) -> None:
        try:
            self._native.epoch_end()
        except DDStoreError as e:
            raise self._classify_collective(e, "epoch_end") from None

    def fence_reset(self) -> None:
        """Force the epoch-fence state machine closed (local,
        idempotent). A fence abort need not be unanimous — a victim
        that died after partially disseminating its barrier notifies
        can let some survivors COMPLETE the fence while others roll
        back — so :func:`elastic.recover` calls this on every rank,
        realigning the group on one pre-fence state before the first
        post-recovery epoch."""
        self._native.fence_reset()

    def barrier(self) -> None:
        """Collective barrier over the store group (data-plane, cheap).
        Failure-aware: a member the heartbeat/ladder already declared
        dead aborts the wait in O(heartbeat) with the classified
        ``ERR_PEER_LOST`` naming it, never a flat
        ``DDSTORE_BARRIER_TIMEOUT_S`` sleep."""
        self._barrier_tag += 1
        try:
            self._native.barrier(self._barrier_tag)
        except DDStoreError as e:
            raise self._classify_collective(e, "barrier") from None

    # -- teardown ----------------------------------------------------------

    def free(self, name: Optional[str] = None) -> None:
        # Collective, like MPI_Win_free in the reference
        # (src/ddstore.cxx:79-96): no rank drops its shard while a peer may
        # still be reading it.
        self.barrier()
        if name is None:
            for n in list(self._meta):
                self._native.free_var(self._wname(n))
                del self._meta[n]
        else:
            self._native.free_var(self._wname(name))
            self._meta.pop(name, None)

    def close(self) -> None:
        """Collective teardown (idempotent): a barrier, then the native
        store and every variable's metadata go."""
        if self._closed:
            return
        self._closed = True
        try:
            self.barrier()
        except Exception:
            pass  # best effort: peers may already be gone on error paths
        self._native.close()
        self._meta.clear()

    # -- props -------------------------------------------------------------

    @property
    def cma_ops(self) -> int:
        """Ops served by the same-host CMA fast path (shared-memory
        mapped gather, or process_vm_readv for borrowed shards)."""
        return self._native.cma_ops

    def plan_stats(self) -> dict:
        """Cumulative scatter-read planner statistics (:meth:`get_batch`):
        batches/rows planned, coalesced runs, per-peer run lists, dedup
        hits, scratch staging, plus the derived ``plan_coalesce_ratio``
        and ``plan_runs_per_peer_list``. Counters are monotone since store
        creation; diff two snapshots for a per-epoch view (that is what
        ``DeviceLoader.metrics`` reports)."""
        return self._native.plan_stats()

    def fault_stats(self) -> dict:
        """Fault-injection and transient-retry counters (see
        :meth:`NativeStore.fault_stats`): injector draws/injections plus
        this store's retry/reconnect/backoff/giveup accounting. Monotone;
        diff snapshots for per-epoch views — ``DeviceLoader.metrics``
        wires this in as ``summary()["faults"]``."""
        return self._native.fault_stats()

    # -- ddtrace: event rings, spans, flight recorder ----------------------
    #
    # Process-global (rings belong to threads; in-process ThreadGroup
    # "ranks" share one trace — every event carries its rank), default
    # OFF with a one-relaxed-load off state. DDSTORE_TRACE=1 or
    # binding.trace_configure(1) turns recording on.

    def trace_dump(self):
        """Every live trace event of this process as a structured
        numpy array (``binding.TRACE_EVENT_DTYPE``), time-sorted.
        Feed per-rank dumps to ``python -m ddstore_tpu_torch.obs
        merge`` for Chrome trace-event JSON, or ``obs.span_tree`` for
        text."""
        from . import binding

        return binding.trace_dump()

    def trace_flight_dump(self):
        """The last flight-recorder snapshot (taken automatically when
        ``kErrPeerLost``/``kErrQuota`` surfaces, a suspect verdict
        lands, or the readahead layer gives up on a window)."""
        from . import binding

        return binding.trace_flight_dump()

    def trace_stats(self) -> dict:
        """Trace counters (``binding.TRACE_STAT_KEYS``): ring/thread
        gauges + monotone captured/dropped/flight/span totals."""
        from . import binding

        return binding.trace_stats()

    def trace_summary(self) -> dict:
        """The ``summary()["trace"]`` payload: counters, ring
        occupancy, and (while tracing) measured span-latency p50/p99
        per (op class, route, peer) from the ring data.
        ``DeviceLoader.metrics`` wires this in automatically."""
        from . import binding
        from .obs import trace_summary

        st = binding.trace_stats()
        events = binding.trace_dump() if st.get("enabled") else None
        return trace_summary(st, events)

    # -- ddmetrics: live latency histograms + SLO monitor ------------------
    #
    # Per-store (unlike the process-global trace rings), always-on
    # (DDSTORE_METRICS, default 1): log2-bucketed latency/bytes
    # histograms per (op class, route, peer, reading tenant), updated
    # at op end with a few relaxed atomic increments — live
    # p50/p90/p99 WITHOUT tracing. ``cluster_metrics`` pulls every
    # peer's snapshot over the control plane and merges one cluster
    # view; the SLO monitor evaluates per-tenant objectives over
    # per-window deltas of the same histograms.

    def metrics_configure(self, enabled: int) -> None:
        """Flip this store's histograms at runtime (0/1; -1 keeps).
        Load-time knob: ``DDSTORE_METRICS`` (default on)."""
        self._native.metrics_configure(enabled)

    def metrics_enabled(self) -> bool:
        return self._native.metrics_enabled()

    def metrics_reset(self) -> None:
        self._native.metrics_reset()

    def metrics_snapshot(self):
        """This rank's live histogram cells
        (``binding.METRICS_CELL_DTYPE`` structured array)."""
        return self._native.metrics_snapshot()

    def metrics_pull(self, target: int):
        """One peer's cells over the control plane (``kOpMetrics`` on
        the dedicated heartbeat connection — never a data lane, never
        an injector draw; bounded by the control-retry ladder). Raises
        ``DDStoreError(ERR_PEER_LOST)`` for a suspected/dead peer."""
        return self._native.metrics_pull(target)

    def cluster_metrics(self):
        """The CLUSTER latency surface: every reachable rank's cells
        merged bucket-wise (``obs.merge_metrics``). Returns
        ``(cells, dead)`` where ``dead`` lists peers that could not be
        pulled (suspected/unreachable — the view assembles around
        them, no give-up, no exception)."""
        from .binding import DDStoreError
        from .obs import merge_metrics

        snaps = []
        dead = []
        for r in range(self.world):
            try:
                snaps.append(self.metrics_snapshot() if r == self.rank
                             else self.metrics_pull(r))
            except DDStoreError:
                dead.append(r)
        return merge_metrics(snaps), dead

    def metrics_stats(self) -> dict:
        """Histogram registry counters
        (``binding.METRICS_STAT_KEYS``)."""
        return self._native.metrics_stats()

    def metrics_summary(self) -> dict:
        """The ``summary()["latency"]`` payload: per-cell count/mean/
        p50/p90/p99 (``obs.latency_table`` over this rank's live
        cells). ``DeviceLoader.metrics`` wires this in automatically
        and reports per-epoch deltas."""
        from .obs import latency_table

        return latency_table(self.metrics_snapshot())

    def set_tenant_slos(self, spec: str) -> None:
        """Replace the per-tenant latency objectives
        (``"t=p99:5ms,t2=p50:200us"``; a bare ``"p99:5ms"`` names the
        default tenant; empty clears). Evaluation windows restart at
        NOW. Load-time knob: ``DDSTORE_TENANT_SLOS``."""
        self._native.slo_configure(spec)
        self._last_slo_breaches = []

    def evaluate_slos(self) -> list:
        """Evaluate every objective over the histogram delta since the
        last evaluation (rate-limited by ``DDSTORE_SLO_WINDOW_MS``).
        Returns breach dicts ``{tenant, pct, threshold_ms,
        measured_ms, count}``; each breach has already emitted a
        ``slo_breach`` trace event and dumped the flight recorder
        (while tracing is on). The loader calls this at epoch
        boundaries and fires the scheduler's replan trigger per
        breached tenant."""
        evals_before = self._native.slo_stats()["evaluations"]
        rows = self._native.slo_evaluate()
        out = []
        if rows:
            tenants = self._native.metrics_tenants()
            for slot, pct, thr_ns, low_ns, count in rows:
                tenant = tenants[slot] if 0 <= slot < len(tenants) \
                    else f"slot{slot}"
                out.append({"tenant": tenant, "pct": int(pct),
                            "threshold_ms": thr_ns / 1e6,
                            "measured_ms": low_ns / 1e6,
                            "count": int(count)})
        # A rate-limited call (inside DDSTORE_SLO_WINDOW_MS) is not an
        # evaluation: keep the previous verdict on the books.
        if rows or \
                self._native.slo_stats()["evaluations"] != evals_before:
            self._last_slo_breaches = out
        return out

    def slo_stats(self) -> dict:
        """SLO monitor counters (``binding.SLO_STAT_KEYS``)."""
        return self._native.slo_stats()

    def slo_summary(self) -> dict:
        """The ``summary()["slo"]`` payload: monitor counters plus the
        most recent evaluation's breach list."""
        out = dict(self.slo_stats())
        out["last_breaches"] = list(
            getattr(self, "_last_slo_breaches", []))
        return out

    # -- replication / failover / health ----------------------------------

    @property
    def replication(self) -> int:
        """Replication factor in force (``DDSTORE_REPLICATION`` clamped
        to ``[1, world]``). At R > 1 every rank hosts read-only mirrors
        of the next R-1 ranks' shards; reads to a dead/suspected peer
        transparently fail over to its replica chain, and
        ``kErrPeerLost`` fires only when all R holders are gone."""
        return self._native.replication

    def replica_set(self, owner: int) -> list:
        """Replica chain of ``owner``'s shard, primary first (chain
        placement: ``[owner, owner-1, ..., owner-R+1] mod world``)."""
        return self._native.replica_set(owner)

    def refresh_mirrors(self) -> None:
        """Re-pull every mirror this rank hosts, creating missing ones
        — the elastic-recovery rebuild (collective discipline is the
        caller's; :func:`elastic.recover`/``rejoin`` barrier around
        it). Suspected owners are skipped: their mirror keeps the last
        good bytes, which is exactly the copy failover is serving."""
        self._native.refresh_mirrors()

    def health_state(self) -> list:
        """Per-peer suspicion flags (heartbeat verdicts ∪ data-path
        ladder give-ups), one bool per rank."""
        return self._native.health_state()

    def suspected_peers(self) -> list:
        """Ranks currently suspected dead."""
        return [r for r, s in enumerate(self.health_state()) if s]

    def mark_suspect(self, target: int, suspected: bool = True) -> None:
        """Force a peer into (or out of) the suspect set (test hook;
        the failover router short-circuits suspected peers)."""
        self._native.mark_suspect(target, suspected)

    def heartbeat_configure(self, interval_ms: int,
                            suspect_n: int = 0) -> None:
        """(Re)start the heartbeat detector (``interval_ms`` <= 0
        stops it; ``suspect_n`` <= 0 keeps the env/default)."""
        self._native.heartbeat_configure(interval_ms, suspect_n)

    def failover_stats(self) -> dict:
        """Replicated-read failover + heartbeat counters (see
        :data:`binding.FAILOVER_STAT_KEYS`). Monotone except the
        gauges; ``DeviceLoader.metrics`` wires this in as
        ``summary()["failover"]``."""
        return self._native.failover_stats()

    # -- end-to-end data integrity -----------------------------------------

    @property
    def verify_mode(self) -> bool:
        """Reader-side checksum verification in force
        (``DDSTORE_VERIFY=1`` or :meth:`integrity_configure`). Off by
        default — the unverified tree is byte-, error-code- and
        seeded-fault-counter-identical to the pre-integrity store."""
        return bool(self._native.integrity_stats().get("verify_mode"))

    def integrity_configure(self, verify: int = -1,
                            scrub_ms: int = -1) -> None:
        """Runtime integrity toggles: ``verify`` -1 keeps / 0 off / 1
        on; ``scrub_ms`` -1 keeps / 0 stops the background scrubber /
        >0 (re)starts it at that per-mirror tick (load-time:
        ``DDSTORE_VERIFY`` / ``DDSTORE_SCRUB_MS``)."""
        self._native.integrity_configure(verify, scrub_ms)

    def integrity_stats(self) -> dict:
        """Integrity counters (``binding.INTEGRITY_STAT_KEYS``):
        verified reads/bytes, the mismatch → seq-retry →
        primary-retry → replica ladder's activity, surfaced
        ``ERR_CORRUPT`` errors, and the scrubber's
        checked/divergent/repaired ledger. Monotone except the gauges;
        ``DeviceLoader.metrics`` wires this in as
        ``summary()["integrity"]``."""
        return self._native.integrity_stats()

    def row_sums(self, name: str, row0: int = 0,
                 count: Optional[int] = None):
        """This rank's per-row checksum table slice for ``name`` as
        ``(sums, seq)`` (test/debug hook; the verified-read machinery
        fetches peers' tables over the control plane itself)."""
        return self._native.integrity_sums(self._rname(name), row0,
                                           count)

    def scrub_once(self) -> int:
        """One synchronous scrub pass over every mirror this rank
        hosts (the deterministic test/bench hook; ``DDSTORE_SCRUB_MS``
        runs the same check one mirror per tick in the background).
        Returns the number of divergent mirrors found; repairs (the
        row-aligned re-pull) run inline and are counted in
        :meth:`integrity_stats`."""
        return self._native.integrity_scrub()

    # -- tiered storage: hot-row cache + cold placement --------------------

    def tier_configure(self, cache_bytes: int = -1) -> None:
        """Runtime hot-row cache budget (bytes; 0 disables and evicts
        everything, < 0 keeps; load-time:
        ``DDSTORE_TIER_CACHE_BYTES``). The readahead engine warms the
        cache with upcoming windows' row lists automatically whenever
        the budget is non-zero — size it to hold (ring depth +
        prefetch depth + 1) windows of the active variables."""
        self._native.tier_configure(cache_bytes)

    def set_tier_placement(self, tenant: str, cold: bool) -> None:
        """Placement policy for ``tenant``'s replication mirrors and
        snapshot kept copies: ``cold`` lands them as file-backed
        mappings under ``DDSTORE_TIER_COLD_DIR`` (NVMe page cache,
        evictable) instead of pinned RAM — a busy trainer pins RAM, an
        eval snapshot reader tolerates NVMe latency. Load-time:
        ``DDSTORE_TIER_PLACEMENT``."""
        self._check_tenant_label(tenant)
        self._native.set_tier_placement(tenant, cold)

    def var_tier(self, name: str) -> str:
        """The registered storage tier of ``name``: ``"hot"`` (RAM) or
        ``"cold"`` (file-backed)."""
        return "cold" if self._native.var_tier(self._rname(name)) else \
            "hot"

    def cache_prefetch(self, name: str, rows, window: int = 0) -> None:
        """Warm the hot-row cache with sorted-unique global ``rows`` of
        ``name`` under eviction key ``window`` (advisory; the fill runs
        detached on the native async pool and is charged against the
        reading tenant's byte quota until eviction). The readahead
        engine calls this with its upcoming windows' row lists — a free
        lookahead, the plan exists before the window is issued."""
        self._require(name)
        self._native.cache_prefetch(self._rname(name), rows,
                                    window=window,
                                    tenant=self._read_tenant())

    def cache_evict(self, window: int = -1) -> int:
        """Evict window ``window``'s hot-cache entries (< 0: every
        entry); returns the count evicted. The readahead engine evicts
        each window as its last batch is consumed."""
        return self._native.cache_evict(window)

    def tiering_stats(self) -> dict:
        """Tiering counters (:data:`binding.TIERING_STAT_KEYS`): cache
        budget/occupancy gauges, cold-tier registrations, and the
        monotone hit/miss/fill/evict ledger. Monotone except the
        gauges; ``DeviceLoader.metrics`` wires this in as
        ``summary()["tiering"]``."""
        return self._native.tiering_stats()

    def check_health(self) -> list:
        """Poll the liveness view and fire the peer listeners exactly
        once per NEW suspect (the scheduler replans routes/lanes off a
        dead peer immediately instead of at the next deadline burn).
        Returns the newly suspected ranks."""
        now = frozenset(self.suspected_peers())
        fresh = sorted(now - self._known_suspects)
        self._known_suspects = now
        if fresh:
            self._fire_peer_listeners()
        return fresh

    def set_retry_deadline(self, seconds: float) -> None:
        """Override this store's transient-retry deadline (seconds;
        ``<= 0`` restores ``DDSTORE_OP_DEADLINE_S``). The degraded
        readahead path shares one deadline budget across a window
        give-up and its per-batch refetch through this; per-store, so
        other stores keep their full budgets."""
        self._native.set_retry_deadline(seconds)

    def lane_state(self) -> dict:
        """Striped-lane autotuner snapshot (TCP backend): configured
        pool size (``DDSTORE_TCP_LANES``), the lane count striped reads
        currently engage, whether the tuner parked, and the best
        measured stripe bandwidth. ``{}`` for the local backend."""
        return self._native.lane_state()

    def lane_bytes(self, target: int = -1) -> list:
        """Per-lane response bytes over the wire path since store
        creation (``target >= 0`` for one peer, ``-1`` summed across
        peers). Monotone — ``DeviceLoader.metrics`` diffs this per epoch
        into ``summary()["bytes_moved"]``'s lane view. ``[]`` for the
        local backend."""
        return self._native.lane_bytes(target)

    def transport_facts(self) -> dict:
        """First-class wire-backend verdict: ``backend`` (the store
        backend), ``wire`` ("uring" when the io_uring loop is engaged,
        else "tcp"/"local"), ``uring_engaged`` and ``uring_reason``
        (the capability probe's words when a requested uring backend
        fell back — never a crash). Bench/diag record this so a
        TCP-fallback run is diagnosable from its artifacts alone."""
        facts = {"backend": self.backend, "wire": self.backend,
                 "uring_engaged": False, "uring_reason": ""}
        if self.backend != "tcp":
            return facts
        state = self._native.uring_state()
        if state < 0:  # plain TCP handle
            return facts
        facts["uring_engaged"] = state == 1
        facts["uring_reason"] = self._native.uring_reason()
        facts["wire"] = "uring" if state == 1 else "tcp"
        return facts

    # -- cost-model scheduler hooks ---------------------------------------

    def sched_cells(self) -> list:
        """Warm-window measurement cells (router + lane tuners) for the
        cost-model scheduler (:mod:`ddstore_tpu_torch.sched`): one dict per
        (source, class, knob) cell with its EWMA bytes/s and clean
        sample count. ``[]`` for the local backend."""
        return self._native.sched_cells()

    def sched_pin_route(self, cls: int, mode: int) -> None:
        """Planner route pin (0 = CMA, 1 = TCP, -1 = release) for one
        traffic class. No-op on the local backend (no router)."""
        try:
            self._native.sched_pin_route(cls, mode)
        except DDStoreError:
            pass  # non-TCP backend: nothing to pin

    def sched_pin_lanes(self, cls: int, lanes: int) -> None:
        """Planner lane-width pin (>= 1, or -1 to release) for one
        traffic class; a width above the lane pool is clamped to the
        pool. No-op on the local backend (no lanes). The native setter
        refuses widths above 64 rather than clamping them, so the clamp
        happens here, and a refusal on a TCP store surfaces."""
        pool = self._native.lane_state().get("max_lanes")
        if pool is None:
            return  # non-TCP backend: nothing to pin
        if lanes >= 1:
            lanes = min(int(lanes), int(pool))
        self._native.sched_pin_lanes(cls, lanes)

    def set_async_width(self, n: int) -> None:
        """Async admission width override (<= 0 restores the
        ``DDSTORE_ASYNC_THREADS`` / core-ladder default)."""
        self._native.set_async_width(n)

    @property
    def async_width(self) -> int:
        """The async admission width currently in force."""
        return self._native.async_width

    def add_peer_listener(self, cb) -> None:
        """Register a zero-arg callable invoked after any peer endpoint
        changes (:meth:`update_peer` — elastic recovery re-pointing a
        rank at a replacement process). The cost-model scheduler hooks
        its topology-change replan here: the native tuners AND the
        planner pins reset on a peer swap, so the plan must be rebuilt
        from fresh samples."""
        self._peer_listeners.append(cb)

    def update_peer(self, target: int, host: str, port: int) -> None:
        """Re-point one peer at a new endpoint (elastic recovery) and
        notify peer listeners (scheduler replan). Native side closes the
        stale connections, re-probes CMA, resets the adaptive tuners,
        releases every planner pin and clears the peer's suspicion (the
        replacement gets a clean liveness slate)."""
        self._native.update_peer(target, host, port)
        self._known_suspects = self._known_suspects - {target}
        self._fire_peer_listeners()

    def _fire_peer_listeners(self) -> None:
        # Prune dead listeners first (a collected Scheduler advertises
        # its death via the closure's `alive` attribute) — long-lived
        # stores see one registration per discarded loader.
        self._peer_listeners = [
            cb for cb in self._peer_listeners
            if getattr(cb, "alive", lambda: True)()]
        for cb in list(self._peer_listeners):
            try:
                cb()
            except Exception:
                pass  # observability hook; never fails recovery

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.size

    # -- tenant namespaces / snapshot epochs -------------------------------
    #
    # The root DDStore IS the default tenant "": both hooks are the
    # identity, so every pre-tenancy call path (and its native names) is
    # byte-identical. ``attach()`` returns a TenantHandle whose hooks
    # scope registrations to "\x02<tenant>\x02<name>" and (for
    # ``snapshot=True``) wrap reads in a pinned snapshot view.

    def _wname(self, name: str) -> str:
        """Native registry name for writes/registration."""
        return name

    def _rname(self, name: str) -> str:
        """Native registry name for reads/metadata."""
        return name

    def _read_tenant(self) -> str:
        """Tenant label async reads are admitted (QoS shares) and
        ledgered under. "" on the root store = derive from the variable
        name, the pre-tenancy behavior; a TenantHandle reports its own
        label so reads of the SHARED default namespace still count
        against the reading tenant's share."""
        return ""

    def attach(self, tenant: str = "", snapshot: bool = False):
        """Attach a tenant-scoped handle to this (long-lived, shared)
        store. The handle shares the native store, group and rank but
        scopes every registration to its own namespace — handles of
        different tenants cannot see, read, update, or free each
        other's variables. The DEFAULT namespace (variables registered
        through this root store) stays readable from every handle —
        that is how an eval or inference job attaches to the resident
        training shards.

        ``snapshot=True`` additionally pins the CURRENT content version
        of every shard on every rank: the handle is read-only and its
        reads stay byte-stable while the owner keeps calling
        ``update()`` + epoch fences (copy-on-publish keeps the pinned
        version for updated shards only; ``detach()`` — or the context
        manager exit — releases the pins and reclaims kept copies on
        last detach). The acquire places pins rank by rank, so do not
        race it against a writer's ``update``: attach at a quiescent
        point (between epoch fences, or after a ``barrier()`` with the
        writer) or the snapshot may pin different content versions on
        different ranks. Updates landing AFTER the acquire are exactly
        what the pins protect against."""
        from .tenant import TenantHandle

        return TenantHandle(self, tenant, snapshot=snapshot)

    def set_tenant_quota(self, tenant: str, max_bytes: int,
                         max_vars: int = -1) -> None:
        """Byte/var registration budget for ``tenant`` (< 0 =
        unlimited; runtime equivalent of ``DDSTORE_TENANT_QUOTAS``).
        An over-budget ``add``/``init`` raises ``DDStoreError`` with
        code ``ERR_QUOTA`` (-11) — admission refused, nothing died."""
        self._check_tenant_label(tenant)
        self._native.tenant_set_quota(tenant, max_bytes, max_vars)

    def set_tenant_share(self, tenant: str, share: int) -> None:
        """Async-admission weight (runtime equivalent of
        ``DDSTORE_TENANT_SHARES``): with any share configured, each
        tenant runs at most ``max(1, width * share / total)``
        concurrent async batched reads — one tenant's readahead cannot
        starve another's scatter reads."""
        self._check_tenant_label(tenant)
        self._native.tenant_set_share(tenant, share)

    def set_tenant_lane_budget(self, tenant: str, lanes: int) -> None:
        """QoS lane budget: cap the transport lanes ``tenant``'s
        striped reads engage (<= 0 clears; the cost-model scheduler
        plans these from the shares). No-op on non-TCP backends."""
        self._check_tenant_label(tenant)
        self._native.tenant_set_lane_budget(tenant, lanes)

    @staticmethod
    def _check_tenant_label(tenant: str) -> None:
        """Every native entry point keyed by a tenant label goes
        through here: control characters collide with the native
        name-scoping / names-CSV formats, and the env-spec delimiters
        would desynchronize the Python ledger from the native gate."""
        from .tenant.handle import _check_tenant_label

        _check_tenant_label(tenant)

    def tenant_stats(self) -> Dict[str, dict]:
        """Per-tenant ledger: ``{tenant: {bytes, vars, quota_*,
        read/served traffic, async admissions/deferrals, snapshot
        pins, share}}`` (see ``binding.TENANT_STAT_KEYS``). Monotone
        counters diff per epoch via ``summary()["tenants"]``."""
        return {t: self._native.tenant_stats(t)
                for t in self._native.tenant_names()}

    def snapshot_stats(self) -> dict:
        """This rank's snapshot gauges: active pins, kept versions and
        their RAM cost (the copy-on-publish ledger), plus
        ``reclaimed_pins`` — the monotone count of stranded pins the
        stale-pin reaper released (TTL-expired or dead-owner)."""
        return self._native.snapshot_stats()

    # -- serving gateway ---------------------------------------------------

    def gateway_configure(self, enabled: int = -1, lease_ms: int = -1,
                          defer_ms: int = -1, queue_cap: int = -1,
                          admit_margin_pct: int = -1,
                          lane_share: int = -1,
                          pin_ttl_ms: int = -1) -> None:
        """Runtime serving-gateway (re)configuration; -1 keeps each
        field. ``enabled=1`` clears a previous drain and (re)arms the
        lease reaper; ``pin_ttl_ms`` arms stranded-snapshot-pin
        reclaim even with the gateway off. Load-time knobs:
        ``DDSTORE_GATEWAY`` / ``DDSTORE_GW_*`` /
        ``DDSTORE_SNAP_PIN_TTL_MS``."""
        self._native.gateway_configure(
            enabled, lease_ms, defer_ms, queue_cap, admit_margin_pct,
            lane_share, pin_ttl_ms)

    def gateway_session(self, tenant: str = "", snapshot: bool = False,
                        quota_bytes: int = 0, target: int = -1,
                        max_retries: int = None, seed: int = None):
        """Open an ephemeral reader session against ``target``'s
        gateway (< 0 = this rank): a lease-renewed
        :class:`~ddstore_tpu_torch.gateway.GatewaySession` whose reads honor
        admission control (``ERR_ADMISSION`` → seeded-jitter backoff
        using the retry-after hint). Use as a context manager; a
        reader SIGKILLed mid-session is reaped within O(lease) — its
        pins, quota reservation and lane share released."""
        from .gateway import GatewaySession

        self._check_tenant_label(tenant)
        return GatewaySession(self, tenant=tenant, snapshot=snapshot,
                              quota_bytes=quota_bytes, target=target,
                              max_retries=max_retries, seed=seed)

    def gateway_drain(self, deadline_ms: int = 1000) -> bool:
        """Graceful drain: stop admitting, let in-flight reads finish
        under the deadline, shed the rest with ``ERR_ADMISSION``.
        True when the gateway went quiet. ``elastic.recover`` drains a
        leaving rank through this instead of RSTing its readers;
        ``gateway_configure(enabled=1)`` re-opens."""
        return self._native.gateway_drain(deadline_ms)

    def gateway_reap(self) -> int:
        """One synchronous lease/stale-pin reap pass (the
        deterministic hook for what the background reaper does on its
        cadence). Returns the number of stranded pins reclaimed."""
        return self._native.gateway_reap()

    def gateway_stats(self) -> dict:
        """Gateway counters (``binding.GATEWAY_STAT_KEYS``): session
        gauges, monotone attach/expiry and admission verdicts, and the
        last retry-after hint."""
        return self._native.gateway_stats()

    def _require(self, name: str) -> _VarMeta:
        if name not in self._meta:
            raise KeyError(f"unknown variable {name!r}; registered: "
                           f"{self.variables()}")
        return self._meta[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
