"""Lease-renewed ephemeral reader sessions (see package docstring).

A :class:`GatewaySession` is the client half of the native gateway's
session machinery: ``attach`` places the lease (and optional snapshot
pin + quota reservation) on the serving rank over the dedicated
control connection, a daemon thread heartbeats it at ~lease/3, reads
go through the tenant-scoped view with ``ERR_ADMISSION`` retried under
seeded-jitter backoff, and ``close()`` detaches. If the process dies
instead — SIGKILL mid-read, dropped control connection — the server
side reaps the lease within O(lease) and releases the same resources,
which is the whole point: no client cleanup path is load-bearing.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Optional

import numpy as np

from ..binding import (ERR_ADMISSION, ERR_NOT_FOUND, ERR_TRANSPORT,
                       DDStoreError)

#: ERR_ADMISSION retry budget per read call (env DDSTORE_GW_RETRY_MAX;
#: the native transient ladder has its own DDSTORE_RETRY_MAX — this one
#: is the CLIENT's patience with flow control, not with failures).
_RETRY_MAX_DEFAULT = 8

#: one backoff sleep is clamped to this many ms no matter what the
#: server hints (a draining rank hints its full drain deadline).
_BACKOFF_CAP_MS = 5000


def _env_int(name: str, dflt: int) -> int:
    try:
        return int(os.environ.get(name, "") or dflt)
    except ValueError:
        return dflt


class GatewaySession:
    """One ephemeral reader's attach-read-detach lifecycle.

    Not constructed directly — use :meth:`DDStore.gateway_session`.
    Usable as a context manager; reads (:meth:`get`,
    :meth:`get_batch`) are tenant-scoped (shared default-namespace
    variables stay readable, like any :class:`TenantHandle`) and
    transparently honor the gateway's admission verdicts: a deferral
    that still ends in ``ERR_ADMISSION`` sleeps the server's
    retry-after hint with seeded jitter and retries, up to
    ``max_retries`` (env ``DDSTORE_GW_RETRY_MAX``), then surfaces the
    error with ``.retry_after_ms`` attached.

    ``snapshot=True`` asks the serving rank to hold a snapshot pin for
    the session's lifetime: the owner's copy-on-publish keeps the
    attach-time shard versions alive while this reader streams, and —
    unlike a client-held pin — the lease releases it even if the
    reader is SIGKILLed. ``quota_bytes`` reserves that much of the
    tenant's byte budget for the same lifetime."""

    def __init__(self, store, tenant: str = "", snapshot: bool = False,
                 quota_bytes: int = 0, target: int = -1,
                 max_retries: Optional[int] = None,
                 seed: Optional[int] = None,
                 lease_ms: Optional[int] = None):
        self._store = store
        self._native = store._native
        self.tenant = tenant
        self.target = int(target)
        self.max_retries = (_env_int("DDSTORE_GW_RETRY_MAX",
                                     _RETRY_MAX_DEFAULT)
                            if max_retries is None else int(max_retries))
        if lease_ms is None:
            lease_ms = _env_int("DDSTORE_GW_LEASE_MS", 5000)
        self._lease_s = max(int(lease_ms), 1) / 1000.0
        if seed is None:
            seed = _env_int("DDSTORE_FAULT_SEED", 0)
        self._rng = random.Random(int(seed))
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self.expired = False
        self.renewals_ok = 0
        self.renew_errors = 0
        self.admission_retries = 0
        self.admission_giveups = 0
        self.backoff_s = 0.0
        # Reads go through a tenant-scoped view (namespace + QoS
        # accounting); the session's snapshot pin, if any, lives
        # server-side under the lease, so the view itself is plain.
        self._view = store.attach(tenant) if tenant else store
        self.token = self._native.gateway_attach(
            target=self.target, tenant=tenant, with_snapshot=snapshot,
            quota_bytes=int(quota_bytes))
        self._renewer = threading.Thread(
            target=self._renew_loop, daemon=True,
            name=f"dds-gw-renew-{self.token:#x}")
        self._renewer.start()

    # -- lease -------------------------------------------------------------

    def _renew_loop(self) -> None:
        # Heartbeat at lease/3: the lease survives two consecutive
        # missed/failed beats, so one control-connection drop (the
        # ctrl-conndrop chaos arm) costs a retry, not the session.
        period = self._lease_s / 3.0
        while not self._stop.wait(period):
            try:
                self._native.gateway_renew(self.token, self.target)
                with self._mu:
                    self.renewals_ok += 1
            except DDStoreError as e:
                if e.code == ERR_NOT_FOUND:
                    # The server already reaped us (expiry or drain):
                    # renewing harder cannot help. Reads now race the
                    # released pins — surface via .expired/.alive.
                    with self._mu:
                        self.expired = True
                    return
                with self._mu:
                    self.renew_errors += 1
                # Transient (ERR_TRANSPORT under chaos): next beat
                # retries; the 3x margin absorbs it.
            except Exception:  # noqa: BLE001 — interpreter teardown
                return

    def renew(self) -> None:
        """One synchronous heartbeat (the deterministic test hook)."""
        self._native.gateway_renew(self.token, self.target)
        with self._mu:
            self.renewals_ok += 1

    def alive(self) -> bool:
        """False once the server reaped the lease (the daemon renewer
        learned of it) or :meth:`close` ran."""
        with self._mu:
            return not self.expired and not self._stop.is_set()

    # -- reads -------------------------------------------------------------

    def _admission_retry(self, what: str, fn):
        attempt = 0
        while True:
            try:
                return fn()
            except DDStoreError as e:
                if e.code != ERR_ADMISSION:
                    raise
                if attempt >= self.max_retries or self._stop.is_set():
                    with self._mu:
                        self.admission_giveups += 1
                    raise
                attempt += 1
                hint_ms = int(getattr(e, "retry_after_ms", 0) or 0)
                base = min(max(hint_ms, 1), _BACKOFF_CAP_MS) / 1000.0
                with self._mu:
                    self.admission_retries += 1
                    delay = base * (0.5 + self._rng.random())
                    self.backoff_s += delay
                if self._stop.wait(delay):
                    raise  # closed mid-backoff: surface the deferral

    def get(self, name: str, start: int, count: int = 1,
            out: Optional[np.ndarray] = None) -> np.ndarray:
        """Single-peer row-range read under admission control."""
        return self._admission_retry(
            f"get({name})",
            lambda: self._view.get(name, start, count, out=out))

    def get_batch(self, name: str, indices,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Coalesced multi-peer batch read under admission control."""
        return self._admission_retry(
            f"get_batch({name})",
            lambda: self._view.get_batch(name, indices, out=out))

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> dict:
        """Client-side session ledger (the server-side counters live
        in ``DDStore.gateway_stats``)."""
        with self._mu:
            return {
                "token": self.token,
                "tenant": self.tenant,
                "target": self.target,
                "expired": self.expired,
                "renewals_ok": self.renewals_ok,
                "renew_errors": self.renew_errors,
                "admission_retries": self.admission_retries,
                "admission_giveups": self.admission_giveups,
                "backoff_s": self.backoff_s,
            }

    def close(self) -> None:
        """Stop the renewer and detach (idempotent). A session the
        server already reaped detaches as a no-op; an unreachable
        server (chaos) is also fine — the lease will do the cleanup."""
        if self._stop.is_set():
            return
        self._stop.set()
        if self._renewer.is_alive():
            self._renewer.join(timeout=self._lease_s)
        try:
            self._native.gateway_detach(self.token, self.target)
        except DDStoreError as e:
            if e.code not in (ERR_NOT_FOUND, ERR_TRANSPORT):
                raise
            # Already reaped (expiry beat us to it) or unreachable
            # (the reaper is the backstop) — both are clean exits.

    def __enter__(self) -> "GatewaySession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - best-effort lease goodbye
        try:
            self.close()
        except Exception:
            pass
