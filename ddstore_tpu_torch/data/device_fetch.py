"""Device-collective batch fetch: owner-local reads + one
``all_to_all_single`` (the port of ``ddstore_tpu/data/device_fetch.py``).

The host path (``DDStore.get_batch`` + a copy to the card) reads every
remote row of a shuffled batch over the store's transport into host
memory and then copies the whole batch to the card. The collective path:

* every rank plans the same global permuted batch
  (:func:`plan_device_fetch`: pure numpy, field for field the
  reference's planner),
* rank ``r`` reads only the rows it owns, with one purely **local**
  ``get_batch``, and packs them into its padded send buffer of
  ``n_shards`` equal blocks (block ``j`` = the rows destination ``j``
  wants from ``r``),
* and one ``torch.distributed.all_to_all_single`` over the process group
  delivers every block to its destination, where an ``index_select`` by
  this rank's slice of the plan's inverse permutation restores exact
  batch order (duplicates included) and drops the padding.

The reference is single-controller: one handle stages every owner's
rows and one ``shard_map`` exchanges them. A torch job is one process
per card, so the port runs the per-host form the reference's
``bytes_ledger`` describes: every rank plans the same batch, stages its
own shard, and receives its ``per_shard`` rows. The result on rank ``r``
is byte-identical to ``get_batch(idx[r*per:(r+1)*per])``.

Rows cross the exchange as raw bytes (``uint8`` views of
``(rows, row_bytes)``): one code path for every dtype, exact by
construction. Shapes are static per (batch, world): every (source,
destination) block is padded to the data-independent capacity
``cap = per_shard`` (one shard per owner), so the exchange moves
``world x cap`` rows per rank whatever the ownership pattern.

The bytes-moved ledger keeps the reference's key names so summaries
compare: ``bytes_local_get`` (rows read from the rank's own shard),
``bytes_over_ici`` (the padded off-diagonal blocks the exchange sends;
on the card "ici" names the process group's exchange: NVLink or PCIe
under NCCL, host memory under gloo) and ``bytes_over_dcn`` (0: no row
crosses the store's transport). Each rank ledgers its own share
(:meth:`DeviceFetchPlan.rank_ledger`); summed over the ranks the shares
equal the reference's ``bytes_ledger(row_bytes)``.

Every exchange is a collective: all ranks call it, in the same order,
from one thread (see :class:`StagedFetch`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["DeviceFetchPlan", "StagedFetch", "plan_device_fetch",
           "stage_batch", "stage_ragged_batch", "exchange_staged",
           "exchange_device", "device_fetch_batch",
           "device_fetch_ragged_batch", "host_bytes_over_dcn"]


class DeviceFetchPlan:
    """Pure-host (numpy) plan for one device-collective fetch.

    Built once per index batch; reusable across co-variables fetched with
    the same indices (data + labels share one plan). ``cap``,
    ``per_shard`` and the staged buffer geometry depend only on (batch,
    n_shards, owners), so the exchange's shapes never change across
    batches.
    """

    __slots__ = ("idx", "n_shards", "n_owners", "per_shard",
                 "shards_per_owner", "cap", "dest", "owner", "src", "slot",
                 "staged_pos", "inv", "send_counts", "owner_positions")

    def __init__(self, idx: np.ndarray, n_shards: int, n_owners: int,
                 per_shard: int, shards_per_owner: int, cap: int,
                 dest: np.ndarray, owner: np.ndarray, src: np.ndarray,
                 slot: np.ndarray, staged_pos: np.ndarray, inv: np.ndarray,
                 send_counts: np.ndarray,
                 owner_positions: List[np.ndarray]):
        self.idx = idx
        self.n_shards = n_shards
        self.n_owners = n_owners
        self.per_shard = per_shard
        self.shards_per_owner = shards_per_owner
        self.cap = cap
        self.dest = dest
        self.owner = owner
        self.src = src
        self.slot = slot
        self.staged_pos = staged_pos
        self.inv = inv
        self.send_counts = send_counts
        self.owner_positions = owner_positions

    @property
    def staged_rows(self) -> int:
        """Global staged-buffer rows: every shard sends ``n_shards``
        blocks of ``cap`` rows."""
        return self.n_shards * self.n_shards * self.cap

    def bytes_ledger(self, row_bytes: int,
                     rank: Optional[int] = None) -> dict:
        """Bytes the collective path moves for one batch of this plan,
        as the reference counts them (single-controller accounting).

        * ``bytes_local_get`` — rows an owner reads from its own shard.
        * ``bytes_over_ici`` — padded off-diagonal blocks the exchange
          sends (the diagonal block stays on its own device).
        * ``bytes_over_dcn`` — zero with ``rank=None``; with ``rank``
          given, the rows of other owners that one handle staging every
          owner's rows would pull over the host transport.
        """
        d, cap = self.n_shards, self.cap
        real = int(self.send_counts.sum()
                   - np.trace(self.send_counts))
        b = int(self.idx.size)
        own = b if rank is None else int((self.owner == rank).sum())
        return {
            "bytes_local_get": own * int(row_bytes),
            "bytes_over_ici": d * (d - 1) * cap * int(row_bytes),
            "bytes_over_dcn": (b - own) * int(row_bytes),
            "rows_over_ici": real,
        }

    def rank_ledger(self, row_bytes: int, rank: int) -> dict:
        """One rank's share under per-rank staging (rank ``r`` stages
        shard ``r``): the rows it owns read locally, its ``(d-1)`` padded
        off-diagonal send blocks, the real rows among them, and no
        transport bytes. Summed over the ranks: :meth:`bytes_ledger`
        with ``rank=None``."""
        d, cap, r = self.n_shards, self.cap, int(rank)
        sent = self.send_counts[r]
        return {
            "bytes_local_get": int(self.owner_positions[r].size)
            * int(row_bytes),
            "bytes_over_ici": (d - 1) * cap * int(row_bytes),
            "bytes_over_dcn": 0,
            "rows_over_ici": int(sent.sum() - sent[r]),
        }


def plan_device_fetch(row_starts, indices, n_shards: int,
                      cap: Optional[int] = None) -> DeviceFetchPlan:
    """Partition a global permuted index batch by owner and lay out the
    exchange.

    ``row_starts`` is the store's cumulative-row table
    (:meth:`DDStore.row_starts`, length ``owners + 1``); ownership of
    each index is a vectorized binary search over it. The batch axis
    (``n_shards`` shards) is split contiguously among owners — owner
    ``w`` stages onto shards ``[w*spo, (w+1)*spo)``. Within one
    (owner, destination) group, rows are dealt round-robin across the
    owner's shards: block occupancy is bounded by
    ``cap = ceil(per_shard / spo)`` independent of the batch's ownership
    pattern, which is what keeps the exchange shape static.

    The default ``cap`` is that worst case. A tighter ``cap`` shrinks
    the padded exchange; a batch that overflows it raises ``ValueError``
    (fall back to the host path or replan with the default), it is never
    silently truncated.
    """
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    starts = np.ascontiguousarray(row_starts, dtype=np.int64)
    b = idx.size
    d = int(n_shards)
    w = len(starts) - 1
    if b == 0:
        raise ValueError("plan_device_fetch: empty index batch")
    if d <= 0 or b % d:
        raise ValueError(f"plan_device_fetch: batch {b} not divisible by "
                         f"{d} shards")
    if w <= 0 or d % w:
        raise ValueError(f"plan_device_fetch: {d} shards not divisible "
                         f"by {w} owners")
    if idx.min() < 0 or idx.max() >= starts[-1]:
        raise IndexError(f"plan_device_fetch: index out of range "
                         f"[0, {int(starts[-1])})")
    per = b // d
    spo = d // w
    if cap is None:
        cap = -(-per // spo)  # ceil: data-independent per-pair capacity
    cap = int(cap)
    if cap <= 0:
        raise ValueError(f"plan_device_fetch: cap must be positive, "
                         f"got {cap}")
    pos = np.arange(b, dtype=np.int64)
    dest = pos // per
    owner = (np.searchsorted(starts, idx, side="right") - 1).astype(np.int64)
    # Rank of each position inside its (owner, dest) group, positions in
    # ascending batch order (stable sort) — deals the group round-robin
    # over the owner's shards and front-packs each block's slots.
    key = owner * d + dest
    order = np.argsort(key, kind="stable")
    sk = key[order]
    group_start = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    sizes = np.diff(np.r_[group_start, b])
    k_sorted = np.arange(b, dtype=np.int64) - np.repeat(group_start, sizes)
    k = np.empty(b, np.int64)
    k[order] = k_sorted
    src = owner * spo + (k % spo)
    slot = k // spo
    if int(slot.max()) >= cap:
        raise ValueError(
            f"plan_device_fetch: a (src, dest) block needs "
            f"{int(slot.max()) + 1} slots but cap is {cap} — this "
            f"batch's ownership is more skewed than the caller's cap "
            f"allows")
    staged_pos = src * (d * cap) + dest * cap + slot
    inv = (src * cap + slot).astype(np.int32)
    send_counts = np.bincount(src * d + dest,
                              minlength=d * d).reshape(d, d)
    owner_positions = [np.flatnonzero(owner == r) for r in range(w)]
    return DeviceFetchPlan(idx, d, w, per, spo, cap, dest, owner, src,
                           slot, staged_pos, inv, send_counts,
                           owner_positions)


def host_bytes_over_dcn(store, name: str, indices) -> int:
    """Bytes the host path pulls over the network transport for this
    batch: every requested row whose owner is another rank (local rows
    never leave the host)."""
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    if idx.size == 0:
        return 0
    owner = store.owner_of_rows(name, idx)
    return int((owner != store.rank).sum()) * store.row_nbytes(name)


class StagedFetch:
    """Host half of one device-collective fetch on one rank: the plan,
    this rank's filled send buffer (``n_shards * cap`` rows, a numpy
    array or a tensor) and the shard it stages, awaiting
    :func:`exchange_staged`.

    The split exists for thread discipline: staging (local reads +
    buffer fill + the copy to the card) is safe on any worker thread,
    but the exchange is a collective. Collectives launched from several
    threads can interleave (two in-flight exchanges each holding half
    the ranks, or an exchange racing DDP's gradient all-reduce) and
    deadlock, so every exchange — and everything else that launches a
    collective, like the train step — runs on ONE thread, in batch
    order; ``DeviceLoader`` finalizes staged fetches on its consumer
    thread for exactly this reason.
    """

    __slots__ = ("plan", "staged", "shard")

    def __init__(self, plan: DeviceFetchPlan, staged, shard: int):
        self.plan = plan
        self.staged = staged
        self.shard = int(shard)


def _my_positions(plan: DeviceFetchPlan, rank: int) -> np.ndarray:
    """Batch positions rank ``rank`` stages under per-rank staging (one
    shard per owner: shard ``rank`` sends exactly the owner's rows)."""
    if plan.shards_per_owner != 1:
        raise ValueError(
            f"per-rank staging needs one shard per owner; the plan has "
            f"{plan.shards_per_owner}")
    if not 0 <= rank < plan.n_owners:
        raise ValueError(f"rank {rank} is not one of the plan's "
                         f"{plan.n_owners} owners")
    return plan.owner_positions[rank]


def _send_slots(plan: DeviceFetchPlan, rank: int, pos: np.ndarray):
    """Rows of rank ``rank``'s send buffer that batch positions ``pos``
    (all staged by that rank) occupy."""
    return plan.staged_pos[pos] - rank * plan.n_shards * plan.cap


def stage_batch(store, name: str, indices, n_shards: int,
                plan: Optional[DeviceFetchPlan] = None,
                metrics=None,
                rows: Optional[np.ndarray] = None,
                out: Optional[np.ndarray] = None) -> StagedFetch:
    """Host half on this rank: plan (unless given), read the rows this
    rank owns LOCALLY, pack them into its padded send buffer.
    Thread-safe.

    ``rows``, when given, are this rank's owned rows already in batch
    order (``idx[plan.owner_positions[rank]]``, the epoch-readahead
    window gather): no store reads happen here — the rows scatter
    straight into the send buffer, and only the exchange leg is
    ledgered (the window fetch recorded its reads once). ``out`` is an
    optional ``(n_shards * cap, *item)`` buffer (e.g. pinned memory)
    that becomes the send buffer."""
    m = store._require(name)
    if plan is None:
        plan = plan_device_fetch(store.row_starts(name), indices, n_shards)
    r = store.rank
    pos = _my_positions(plan, r)
    shape = (plan.n_shards * plan.cap,) + m.sample_shape
    if out is None:
        staged = np.zeros(shape, m.dtype)
    else:
        if out.shape != shape or out.dtype != m.dtype:
            raise ValueError(f"stage_batch({name}): out is {out.dtype}"
                             f"{out.shape}, expected {m.dtype}{shape}")
        staged = out
        staged.fill(0)
    slots = _send_slots(plan, r, pos)
    rb = store.row_nbytes(name)
    if rows is not None:
        if len(rows) != pos.size:
            raise ValueError(f"stage_batch({name}): {len(rows)} "
                             f"prefetched rows for the {pos.size} rows "
                             f"rank {r} owns in this batch")
        staged[slots] = rows
        if metrics is not None:
            led = plan.rank_ledger(rb, r)
            metrics.add_bytes(bytes_over_ici=led["bytes_over_ici"],
                              rows_over_ici=led["rows_over_ici"])
        return StagedFetch(plan, staged, r)
    if pos.size:
        staged[slots] = store.get_batch(name, plan.idx[pos])
    if metrics is not None:
        metrics.add_bytes(**plan.rank_ledger(rb, r))
    return StagedFetch(plan, staged, r)


def stage_ragged_batch(store, name: str, indices, n_shards: int,
                       max_len: int,
                       plan: Optional[DeviceFetchPlan] = None,
                       metrics=None
                       ) -> Tuple[StagedFetch, StagedFetch]:
    """Host half for a ragged variable on this rank: its own samples
    read locally (the ``add_ragged`` locality invariant keeps a sample's
    index row AND values span on one owner) and padded to the static
    ``max_len`` via the ragged pack. Returns the staged values and the
    staged per-sample lengths (int64, same layout): the lengths ride the
    exchange too, since each rank knows only its own samples'."""
    from .ragged import pad_ragged

    index_var = f"{name}/index"
    values_var = f"{name}/values"
    m = store._require(values_var)
    if plan is None:
        plan = plan_device_fetch(store.row_starts(index_var), indices,
                                 n_shards)
    r = store.rank
    pos = _my_positions(plan, r)
    rows = plan.n_shards * plan.cap
    staged = np.zeros((rows, max_len) + m.sample_shape, m.dtype)
    lengths = np.zeros(rows, np.int64)
    local_bytes = 0
    if pos.size:
        values, lens = store.get_ragged_batch(name, plan.idx[pos])
        local_bytes = values.size * values.dtype.itemsize
        padded, _mask = pad_ragged(values, lens, max_len)
        slots = _send_slots(plan, r, pos)
        staged[slots] = padded
        lengths[slots] = lens
    if metrics is not None:
        led = plan.rank_ledger(max_len * store.row_nbytes(values_var), r)
        led["bytes_local_get"] = local_bytes  # actual elements, unpadded
        metrics.add_bytes(**led)
    return StagedFetch(plan, staged, r), StagedFetch(plan, lengths, r)


def exchange_device(group=None, device=None):
    """Where the exchange's buffers live: on ``device`` — gloo takes CUDA
    tensors in ``all_to_all_single`` and ``all_reduce`` (it copies them
    through host memory itself) — except that NCCL takes nothing but
    the card (the current card when ``device`` is the CPU)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda" and str(dist.get_backend(group)).lower() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def exchange_staged(sf: StagedFetch, group=None, device=None):
    """Device half: one ``all_to_all_single`` of this rank's padded send
    blocks over ``group`` (default: the world), then an ``index_select``
    by this rank's slice of the plan's inverse permutation on ``device``
    (:func:`~ddstore_tpu_torch.parallel.shuffle.exchange_rows`). Returns
    this rank's ``per_shard`` rows in batch order, as a tensor on
    ``device`` (default: the CPU). A collective: every rank of the group
    calls it for the same plan, from the single thread that launches the
    job's other collectives (see :class:`StagedFetch`)."""
    import torch
    import torch.distributed as dist

    from ..parallel.shuffle import exchange_rows

    plan = sf.plan
    d = dist.get_world_size(group)
    r = dist.get_rank(group)
    if d != plan.n_shards:
        raise ValueError(f"exchange_staged: a group of {d} ranks for a "
                         f"plan of {plan.n_shards} shards")
    if r != sf.shard:
        raise ValueError(f"exchange_staged: rank {r} holds shard "
                         f"{sf.shard}'s send buffer")
    send = sf.staged if isinstance(sf.staged, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(sf.staged))
    if send.shape[0] != d * plan.cap:
        raise ValueError(f"exchange_staged: send buffer has "
                         f"{send.shape[0]} rows, the plan {d * plan.cap}")
    per = plan.per_shard
    return exchange_rows(send, plan.inv[r * per:(r + 1) * per], group,
                         "cpu" if device is None else device)


def device_fetch_batch(store, name: str, indices, group=None, device=None,
                       plan: Optional[DeviceFetchPlan] = None,
                       metrics=None):
    """Fetch a global index batch and deliver this rank's ``per_shard``
    slice of it as a tensor on ``device``, moving remote rows through
    the group's exchange instead of the store's transport.

    Byte-identical to ``get_batch(name, idx[r*per:(r+1)*per])`` on rank
    ``r`` — duplicates included — but each rank reads only the rows it
    owns (one coalesced local ``get_batch``) and the delivery is one
    ``all_to_all_single``. Every rank of ``group`` (whose size must be
    the store's world) calls it with the same ``indices``. ``plan`` lets
    co-variables fetched with the same indices share one planning pass;
    ``metrics`` (anything with ``add_bytes(**ledger)``) receives this
    rank's share of the ledger."""
    import torch.distributed as dist

    sf = stage_batch(store, name, indices, dist.get_world_size(group),
                     plan=plan, metrics=metrics)
    return exchange_staged(sf, group, device)


def device_fetch_ragged_batch(store, name: str, indices, max_len: int,
                              group=None, device=None,
                              plan: Optional[DeviceFetchPlan] = None,
                              metrics=None):
    """Ragged variant: samples ride the exchange as fixed-width rows via
    the ragged pack (``pad_ragged`` to the static ``max_len``; longer
    samples are truncated, the same explicit overflow policy).

    Returns ``(padded, lengths)`` for this rank's ``per_shard`` slice:
    ``padded`` a tensor ``(per_shard, max_len, *item)`` on ``device``,
    ``lengths`` the per-sample lengths (numpy int64, in batch order;
    they cross the exchange beside the values)."""
    import torch.distributed as dist

    sf, sl = stage_ragged_batch(store, name, indices,
                                dist.get_world_size(group), max_len,
                                plan=plan, metrics=metrics)
    padded = exchange_staged(sf, group, device)
    lengths = exchange_staged(sl, group, device).cpu().numpy()
    return padded, lengths
