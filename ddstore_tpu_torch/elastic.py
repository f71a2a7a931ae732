"""In-run elastic recovery (the port of ``ddstore_tpu/elastic.py``):
survive a rank death without restarting the job.

* Survivors hit a bounded-timeout :class:`DDStoreError` on reads to the
  dead rank (``ERR_PEER_LOST``; the loader surfaces it from its
  iterator), then call :func:`recover` — a collective over the NEW
  world.
* A supervisor relaunches the dead rank, which calls :func:`rejoin`: it
  builds a fresh ``DDStore`` and re-registers every variable from its
  last checkpoint shard (``utils.checkpoint.save_shard`` format).
* Everyone meets at a **generation-stamped rendezvous directory**
  (``<root>/gen<G>``, a :class:`~ddstore_tpu_torch.rendezvous.FileGroup`):
  survivors target their local generation + 1, the replacement reads
  the last committed generation from ``<root>/GENERATION`` — so
  repeated recoveries in one run compose, and a late replacement can
  never join a stale generation.
* Endpoints are re-exchanged; survivors re-point every joiner rank (and
  any peer whose endpoint changed) via native ``UpdatePeer`` — stale
  connections closed, CMA re-probed against the new pid — while the
  replacement gets the full table via the normal construction path.
  Barrier sequence numbers are re-synced to the max so the data-plane
  dissemination barrier stays aligned.

Scope: the recovered shard holds the dead rank's LAST CHECKPOINT — rows
updated after that checkpoint are rolled back on that shard (the same
contract every checkpoint/restore system has). Works for any number of
simultaneous deaths as long as at least one rank survives; call it
between training steps. The store recovers; a ``torch.distributed``
group that included the dead rank does not (rebuild it, or train
without one, as ``examples/elastic_train.py`` does). A
``DeviceLoader`` over a recovered store needs only a new iterator.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .binding import DDStoreError
from .rendezvous import FileGroup
from .store import DDStore, _row_disp, _VarMeta

__all__ = ["recover", "rejoin"]

_GEN_FILE = "GENERATION"


def _default_timeout() -> float:
    """The rendezvous must outlast the slowest death-detection path.
    With the heartbeat detector ON, a survivor wedged in a barrier or
    epoch fence aborts in O(heartbeat) (the detector-integrated
    barrier); the worst case is the detector-OFF one — a survivor
    notices only after DDSTORE_BARRIER_TIMEOUT_S (default 300 s).
    Every survivor must reach recover() before the first one's
    rendezvous expires, so the default waits that long plus margin."""
    try:
        barrier_s = float(os.environ.get("DDSTORE_BARRIER_TIMEOUT_S", 300))
    except ValueError:
        barrier_s = 300.0
    return max(120.0, barrier_s + 60.0)


def _gen_dir(root: str, gen: int) -> str:
    return os.path.join(root, f"gen{gen}")


def _read_generation(root: str) -> int:
    try:
        with open(os.path.join(root, _GEN_FILE)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def _commit_generation(root: str, gen: int) -> None:
    # Every participant writes the same value; os.replace is atomic, so
    # concurrent writers are idempotent.
    path = os.path.join(root, _GEN_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(str(gen))
    os.replace(tmp, path)


def _vars_meta(store: DDStore) -> dict:
    """Variable registry a survivor publishes: identity fields first
    (dtype/shape/row counts — every rank must agree on these) plus the
    tiering state (``readonly`` == the shard is served from a read-only
    mmap). Tiering is EXCLUDED from the agreement check: a survivor may
    have spilled a variable after the victim's last checkpoint, which
    changes where its bytes live but not what they are."""
    return {name: (m.dtype.str, list(m.sample_shape), list(m.all_nrows),
                   bool(m.readonly))
            for name, m in store._meta.items()}


def _identity(meta: dict) -> dict:
    """The agreement-checked subset of :func:`_vars_meta`."""
    return {name: tuple(v[:3]) for name, v in meta.items()}


def _sync_state(store: DDStore, group, *, joiner: bool,
                ckpt_dir: Optional[str]) -> list:
    """Second collective of a recovery generation: align barrier sequence
    numbers and variable registries. Survivors publish their metadata;
    the joiner re-registers every variable from its checkpoint shard.
    Returns the list of joiner ranks (the ones that published no
    metadata) — survivors re-point those peers UNCONDITIONALLY, endpoint
    change or not (a replacement relaunched on the same host:port is
    still a new process whose CMA pid must be re-probed)."""
    info = group.allgather(
        (store._barrier_tag, store._native.barrier_seq,
         None if joiner else _vars_meta(store)))
    # Everyone adopts the max barrier tag AND the transport's collective
    # sequence count, so the next data-plane barrier lines up on all
    # ranks (a joiner starts both from zero; survivors are already at
    # the max — their adoption is a no-op).
    store._barrier_tag = max(t for t, _, _ in info)
    store._native.set_barrier_seq(max(s for _, s, _ in info))
    joiners = [r for r, (_, _, v) in enumerate(info) if v is None]
    metas = [v for _, _, v in info if v is not None]
    if not metas:
        raise DDStoreError(-7, "elastic recovery: no surviving rank has "
                               "variable metadata to rebuild from")
    ref = metas[0]
    for other in metas[1:]:
        if _identity(other) != _identity(ref):
            raise DDStoreError(-9, "elastic recovery: survivors disagree "
                                   "on variable metadata")
    if not joiner:
        if _identity(_vars_meta(store)) != _identity(ref):
            raise DDStoreError(-9, "elastic recovery: this rank's variable "
                                   "registry diverged from the group's")
        return joiners
    if ckpt_dir is None:
        raise ValueError("rejoin() needs ckpt_dir to rebuild the shard")
    from .utils.checkpoint import _stem

    for name in sorted(ref):
        dt, sshape, all_nrows = ref[name][:3]
        # Tiering follows the group: when EVERY survivor serves the
        # variable from a read-only mapping (it was spilled/add_mmap'd),
        # the replacement must come back the same way — mmap the
        # checkpoint shard instead of re-materializing it in RAM, or one
        # recovery would silently un-spill a variable that was spilled
        # precisely because it does not fit.
        tiered = all(v[name][3] for v in metas)
        dtype = np.dtype(dt)
        sample_shape = tuple(sshape)
        nrows = int(all_nrows[store.rank])
        stem = _stem(ckpt_dir, name, store.rank)
        if nrows:
            try:
                with open(stem + ".json") as f:
                    side = json.load(f)
            except OSError as e:
                raise DDStoreError(
                    -7, f"rejoin: no checkpoint sidecar for {name!r} at "
                        f"{stem}.json ({e}) — was save_shard called before "
                        "the crash?") from None
            if side["nrows"] != nrows or side["dtype"] != dtype.str \
                    or tuple(side["sample_shape"]) != sample_shape:
                raise DDStoreError(
                    -9, f"rejoin: checkpoint {stem}.bin holds "
                        f"{side['nrows']} rows of {side['dtype']} "
                        f"{tuple(side['sample_shape'])} but the group "
                        f"expects {nrows} rows of {dtype.str} "
                        f"{sample_shape} — stale or foreign checkpoint")
            if tiered:
                arr = np.memmap(stem + ".bin", dtype=dtype, mode="r",
                                shape=(nrows,) + sample_shape)
            else:
                arr = np.fromfile(stem + ".bin", dtype=dtype).reshape(
                    (nrows,) + sample_shape)
        else:
            arr = np.empty((0,) + sample_shape, dtype)
        if tiered:
            # Serve straight from page cache (the rejoin half of
            # spill_to_disk): the mapping is pinned in the meta exactly
            # like add_file's cold tier, and update stays refused.
            store._native.add(name, arr, all_nrows, copy=False)
            store._meta[name] = _VarMeta(dtype, sample_shape,
                                         _row_disp(sample_shape),
                                         all_nrows, pinned=arr,
                                         readonly=True, tier="cold")
            store._native.set_var_tier(name, 1)
        else:
            store._native.add(name, np.ascontiguousarray(arr), all_nrows,
                              copy=True)
            store._meta[name] = _VarMeta(dtype, sample_shape,
                                         _row_disp(sample_shape),
                                         all_nrows)
    return joiners


def recover(store: DDStore, root: str,
            timeout: Optional[float] = None) -> None:
    """Survivor side. Collective over the new world: EVERY surviving rank
    must call this after a peer death, and blocks until the supervisor's
    replacement rank has joined via :func:`rejoin`. Detection is a
    bounded-timeout :class:`DDStoreError` on a read or barrier; a
    survivor whose access pattern never touches the dead rank must be
    told out of band (or reach the next collective, which will error).
    The default ``timeout`` covers the SLOWEST detection path — a peer
    wedged in a data-plane barrier notices only after
    ``DDSTORE_BARRIER_TIMEOUT_S`` — so early detectors wait for it.

    On return the store serves every global row again: survivors kept
    their shards, the replacement restored its shard from its last
    checkpoint, and the control-plane group has been swapped for the new
    generation's."""
    if store._endpoints is None:
        raise ValueError("recover() requires the tcp backend")
    if store.group is not store.world_group:
        # width=... replica-split stores: the generation bookkeeping in
        # `root` is one sequence, not one per replica group — two
        # replicas recovering would cross-wire each other's rendezvous.
        raise ValueError("elastic recovery does not support replica-"
                         "split (width=...) stores yet; recover the "
                         "full-world store")
    if timeout is None:
        timeout = _default_timeout()
    # Serving gateway: quiesce ephemeral readers BEFORE the topology
    # swap. Drain stops admitting, lets in-flight reads finish under a
    # short deadline, and sheds the rest with ERR_ADMISSION
    # (defer-not-peer-lost: sessions back off on the retry-after hint
    # and resume) — instead of their reads dying on re-pointed sockets
    # mid-swap and masquerading as a second failure. Re-enabled after
    # the post-recovery barrier proves the new world.
    gw_draining = False
    try:
        if store.gateway_stats().get("enabled", 0):
            store.gateway_drain(deadline_ms=1000)
            gw_draining = True
    except Exception:  # noqa: BLE001 — a gateway-less store recovers fine
        pass
    gen = store._generation + 1
    group = FileGroup(_gen_dir(root, gen), store.rank, store.world, timeout)
    endpoints = group.allgather(
        (store._advertised, store._native.server_port))
    joiners = _sync_state(store, group, joiner=False, ckpt_dir=None)
    for r, ep in enumerate(endpoints):
        ep = tuple(ep)
        # Joiner ranks are re-pointed even at an UNCHANGED endpoint: a
        # relaunch on the same host:port is still a new process — stale
        # sockets must close and CMA must re-probe the new pid.
        if r != store.rank and (r in joiners
                                or ep != store._endpoints[r]):
            # Through the DDStore wrapper, not the native handle: the
            # cost-model scheduler's peer listeners must see the
            # topology change (the native tuners and planner pins reset
            # on the swap; the plan must be rebuilt).
            store.update_peer(r, ep[0], ep[1])
    store._endpoints = [tuple(e) for e in endpoints]
    store.group = group
    store._generation = gen
    _commit_generation(root, gen)
    # Fence realignment: a fence abort need not have been unanimous (a
    # victim that partially disseminated its notifies can let some
    # survivors complete the fence others aborted), so every survivor
    # forces its fence state machine closed here — the group re-enters
    # its first post-recovery epoch from one agreed state. Idempotent
    # and local; the replacement's fresh store starts closed anyway.
    store.fence_reset()
    # Data-plane barrier proves end-to-end connectivity of the new world
    # before anyone resumes training. RE-ENTERABLE: this (and the
    # replication rebuild) can itself abort if ANOTHER rank dies
    # mid-recovery — the failure-aware barrier classifies that in
    # O(heartbeat) — and by this point the generation is committed, so
    # the survivors simply run another recover() round (targeting
    # generation gen+1) for the newly dead rank.
    try:
        store.barrier()
        _restore_replication(store)
        if gw_draining:
            # New world proven end-to-end: reopen for ephemeral
            # readers (clears the sticky drain flag; deferred sessions
            # re-admit on their next backoff retry).
            store.gateway_configure(enabled=1)
    except DDStoreError as e:
        raise DDStoreError(
            e.code,
            f"elastic recovery generation {gen}: a peer died during "
            f"the post-recovery collective ({e}); the generation is "
            f"committed — call recover() again to run the next "
            f"recovery round for the newly dead rank") from None


def rejoin(root: str, rank: int, world: int, ckpt_dir: str, *,
           timeout: Optional[float] = None, port: int = 0) -> DDStore:
    """Replacement side: called by the relaunched process in place of the
    normal construction path. Joins the recovery generation's rendezvous,
    builds a fresh tcp :class:`DDStore` (normal endpoint exchange — the
    survivors' :func:`recover` participates in it), re-registers every
    variable from ``ckpt_dir``, and returns the ready store."""
    if timeout is None:
        timeout = _default_timeout()
    gen = _read_generation(root) + 1
    group = FileGroup(_gen_dir(root, gen), rank, world, timeout)
    store = DDStore(group, backend="tcp", port=port)
    _sync_state(store, group, joiner=True, ckpt_dir=ckpt_dir)
    store._generation = gen
    _commit_generation(root, gen)
    store.barrier()
    _restore_replication(store)
    return store


def _restore_replication(store: DDStore) -> None:
    """Third phase of a recovery generation (collective, after the
    connectivity barrier): rebuild the mirror chains for the new world.
    Survivors re-pull the replacement's restored shard into their
    mirrors (it may have rolled back to the checkpoint — a mirror
    holding newer pre-crash bytes would serve rows the owner no longer
    has); the replacement builds its whole chain from scratch. The
    closing barrier makes the restored replication factor live before
    anyone resumes training — a second death right after recovery is
    already covered again."""
    if store.replication <= 1:
        return
    store.refresh_mirrors()
    store.barrier()
