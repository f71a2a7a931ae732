"""Tenant-scoped (and optionally snapshot-pinned) views over one
:class:`~ddstore_tpu_torch.store.DDStore` (the port of
``ddstore_tpu/tenant/handle.py``).

A handle shares the parent's native store, group and rank — attaching
is a local operation (plus, for snapshots, one control round trip per
peer to place the version pins). Isolation is by construction: every
registration the handle makes is scoped to its namespace at the NATIVE
layer, and the Python boundary rejects names that could alias another
namespace (control characters), so two tenants cannot see, read,
update, or free each other's variables no matter what strings they
pass. The default namespace — variables registered through the root
``DDStore`` — stays readable from every handle: that is how an eval or
inference job attaches to the resident training shards.
"""

from __future__ import annotations

from typing import Optional

from ..binding import DDStoreError, ERR_PEER_LOST
from ..store import DDStore

#: native namespace separators. Scoped names are built HERE and only
#: parsed natively (keep in sync with native/store.cc TenantOfVarName
#: / Store::SnapVarName).
TENANT_SEP = "\x02"
SNAP_PREFIX = "\x03s\x03"

#: characters a tenant label may not contain: the native scope
#: separator plus the env-spec delimiters (DDSTORE_TENANT_QUOTAS /
#: _SHARES entries are "t=v" joined by "," with ":" inside values).
_TENANT_BADCHARS = set("=,:")


def scoped_name(tenant: str, name: str) -> str:
    """Native registry name of ``name`` in ``tenant``'s namespace
    (the default tenant ``""`` is the bare name)."""
    if not tenant:
        return name
    return f"{TENANT_SEP}{tenant}{TENANT_SEP}{name}"


def snapshot_name(snap_id: int, native_name: str) -> str:
    """Snapshot-scoped view of a native registry name: the owner
    resolves it to the primary (version unchanged) or the kept copy
    under one registry-lock acquisition."""
    return f"{SNAP_PREFIX}{snap_id}\x03{native_name}"


def _check_tenant_label(tenant: str) -> None:
    if any(ord(c) < 0x20 for c in tenant):
        raise ValueError(f"tenant label {tenant!r} contains control "
                         f"characters")
    bad = _TENANT_BADCHARS.intersection(tenant)
    if bad:
        raise ValueError(f"tenant label {tenant!r} contains reserved "
                         f"spec characters {sorted(bad)}")


class TenantHandle(DDStore):
    """A tenant's view of a shared store (see module docstring).

    Not constructed directly — use :meth:`DDStore.attach`. The handle
    inherits the full read/registration API; writes are scoped to the
    tenant's namespace, reads fall back to the shared default
    namespace, and ``snapshot=True`` makes the handle read-only with
    every read pinned to the acquire-time shard versions.

    Epoch fences are LOCAL NO-OPS on a handle: the store-global fence
    belongs to the owner job (a snapshot reader's epochs must never
    block the writer — that is the point of the snapshot)."""

    def __init__(self, parent: DDStore, tenant: str = "",
                 snapshot: bool = False):
        # Deliberately no super().__init__: the handle BORROWS the
        # parent's native store and group instead of creating its own.
        _check_tenant_label(tenant)
        self._parent = parent
        self.tenant = tenant
        self.is_snapshot = bool(snapshot)
        self.world_group = parent.world_group
        self.group = parent.group
        self.replica_id = parent.replica_id
        self.num_replicas = parent.num_replicas
        self.backend = parent.backend
        self.copy = parent.copy
        self._native = parent._native
        self._advertised = parent._advertised
        self._endpoints = parent._endpoints
        self._generation = 0
        self._peer_listeners = []
        self._known_suspects = frozenset()
        self._gid = getattr(parent, "_gid", None)
        # The default tenant's namespace IS the root registry: share the
        # parent's metadata so both views stay coherent. A named
        # tenant's namespace belongs to the TENANT, not to one handle
        # object — every handle of the tenant (snapshot readers
        # included) shares the one registry the root store keeps.
        self._meta = (parent._meta if tenant == ""
                      else parent._tenant_meta.setdefault(tenant, {}))
        self._snap_id: Optional[int] = None
        if snapshot:
            try:
                self._snap_id = self._native.snapshot_acquire(tenant)
            except DDStoreError as e:
                if e.code == ERR_PEER_LOST:
                    # Rank-by-rank pin placement met a dead peer: the
                    # native acquire UNWOUND the pins it had placed
                    # (all-or-nothing, with one retry pass per live
                    # peer) — best-effort under control-plane chaos: a
                    # pin on a live peer whose unpin failed every
                    # attempt is released when that peer's store
                    # closes. Re-attach after recovery.
                    raise DDStoreError(
                        e.code,
                        f"attach(tenant={tenant!r}, snapshot=True): a "
                        f"peer died during rank-by-rank snapshot-pin "
                        f"placement; the partially placed pins were "
                        f"unwound (best-effort on unreachable live "
                        f"peers). Recover the dead rank "
                        f"(elastic.recover), then re-attach") from None
                raise

    # -- name scoping ------------------------------------------------------

    def _wname(self, name: str) -> str:
        return scoped_name(self.tenant, name)

    def _read_tenant(self) -> str:
        # Async reads are admitted and ledgered under the READING
        # tenant, not the data's owner: an eval tenant streaming the
        # shared default-namespace dataset must burn its own QoS share,
        # not the default tenant's.
        return self.tenant

    def _rname(self, name: str) -> str:
        if name in self._meta:
            n = scoped_name(self.tenant, name)
        elif name in self._parent._meta:
            n = name  # shared default-namespace dataset (read-only view)
        else:
            raise KeyError(
                f"unknown variable {name!r} in tenant "
                f"{self.tenant!r} (cross-tenant reads are refused); "
                f"own: {sorted(self._meta)}, shared: "
                f"{sorted(self._parent._meta)}")
        if self._snap_id is not None:
            n = snapshot_name(self._snap_id, n)
        return n

    def _require(self, name: str):
        if name in self._meta:
            return self._meta[name]
        if name in self._parent._meta:
            return self._parent._meta[name]
        raise KeyError(
            f"unknown variable {name!r} in tenant {self.tenant!r} "
            f"(cross-tenant access is refused); own: "
            f"{sorted(self._meta)}, shared: "
            f"{sorted(self._parent._meta)}")

    # -- write guards ------------------------------------------------------

    def _require_writable(self, what: str) -> None:
        if self._snap_id is not None:
            raise DDStoreError(
                -1, f"{what}: snapshot handle is read-only (detach and "
                    f"re-attach without snapshot=True to write)")

    def add(self, name, arr, copy=None, readonly=False):
        self._require_writable(f"add({name})")
        super().add(name, arr, copy=copy, readonly=readonly)

    def init(self, name, nrows, sample_shape, dtype):
        self._require_writable(f"init({name})")
        super().init(name, nrows, sample_shape, dtype)

    def add_ragged(self, name, samples):
        self._require_writable(f"add_ragged({name})")
        super().add_ragged(name, samples)

    def add_mmap(self, name, path, dtype, sample_shape, mode="r"):
        self._require_writable(f"add_mmap({name})")
        super().add_mmap(name, path, dtype, sample_shape, mode=mode)

    def update(self, name, arr, row_offset=0):
        self._require_writable(f"update({name})")
        if name not in self._meta:
            raise DDStoreError(
                -1, f"update({name}): cross-tenant update refused — "
                    f"the variable is not registered in tenant "
                    f"{self.tenant!r} (shared default-namespace "
                    f"variables are writable only through their owner "
                    f"handle)")
        super().update(name, arr, row_offset)

    def spill_to_disk(self, name, directory, chunk_rows=65536):
        self._require_writable(f"spill_to_disk({name})")
        if name not in self._meta:
            raise DDStoreError(
                -1, f"spill_to_disk({name}): not a tenant "
                    f"{self.tenant!r} variable")
        return super().spill_to_disk(name, directory,
                                     chunk_rows=chunk_rows)

    def free(self, name=None):
        self._require_writable(f"free({name})")
        if name is not None and name not in self._meta:
            raise DDStoreError(
                -1, f"free({name}): cross-tenant free refused — not a "
                    f"tenant {self.tenant!r} variable")
        super().free(name)

    # -- lifecycle / sync --------------------------------------------------

    def attach(self, tenant: str = "", snapshot: bool = False):
        """Handles attach from the ROOT store (one registry of handles
        per job, not a tree)."""
        return self._parent.attach(tenant, snapshot=snapshot)

    def barrier(self) -> None:
        # One collective-tag counter per store: the parent's.
        self._parent.barrier()

    def epoch_begin(self) -> None:
        """Local no-op: the store-global epoch fence is the OWNER
        job's; an attached reader's epochs must not block the writer
        (nor trip the fence state machine)."""

    def epoch_end(self) -> None:
        """Local no-op (see epoch_begin)."""

    def detach(self) -> None:
        """Release the snapshot pins (if any) everywhere. The last
        handle pinning a kept shard version reclaims it. Idempotent;
        the handle's reads serve CURRENT bytes afterwards."""
        if self._snap_id is not None:
            sid, self._snap_id = self._snap_id, None
            self._native.snapshot_release(sid)

    def close(self) -> None:
        """Detach only — the native store belongs to the parent."""
        self.detach()

    def __exit__(self, *exc):
        self.detach()

    def __del__(self):  # pragma: no cover - best-effort pin cleanup
        try:
            self.detach()
        except Exception:
            pass
