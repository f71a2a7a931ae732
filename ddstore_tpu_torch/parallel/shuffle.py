"""Epoch-wise global shuffle and row exchanges over a process group (the
port of ``ddstore_tpu/parallel/shuffle.py``).

Two paths, as in the reference:

* **Device path** — for rows resident on the ranks' devices: each
  function takes a ``torch.distributed`` process group in place of the
  reference's ``Mesh`` and works on THIS rank's local rows (the
  reference's shard of a sharded array). The block exchange is one
  ``all_to_all_single`` with equal blocks; rows cross it as raw bytes
  (``uint8`` views), so every dtype takes the same path, exactly.
  ``global_shuffle_epoch`` is local permutation ∘ block exchange ∘ local
  permutation, every row able to land on every rank.

* **Host path** — for store-resident variables: an arbitrary global
  permutation executed as a one-sided reshard through the store (each
  rank batch-fetches the rows the permutation assigns it, then atomically
  replaces its shard).

Every device-path function is a collective: all ranks of the group call
it, in the same order, from one thread.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_to_all_rows", "exchange_rows", "global_shuffle_epoch",
           "permute_rows", "host_global_shuffle", "ragged_global_shuffle"]


def _byte_rows(t: torch.Tensor) -> torch.Tensor:
    """``(rows, row_bytes)`` uint8 view of a tensor's rows."""
    t = t.contiguous().reshape(t.shape[0], -1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def _exchange_bytes(x: torch.Tensor, group, xdev) -> torch.Tensor:
    """The block exchange as bytes on ``xdev`` (equal blocks: block j of
    every rank goes to rank j, received in source-rank order)."""
    sb = _byte_rows(x)
    if sb.device != xdev:
        sb = sb.to(xdev, non_blocking=sb.is_pinned())
    elif xdev.type == "cuda":
        # x may come from another stream (a loader's copy stream): keep
        # its memory alive until this stream's use of it ends.
        sb.record_stream(torch.cuda.current_stream(xdev))
    recv = torch.empty_like(sb)
    dist.all_to_all_single(recv, sb, group=group)
    return recv


def _xdev(group, device):
    from ..data.device_fetch import exchange_device

    return exchange_device(group, device)


def all_to_all_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Block exchange over ``group``: this rank's rows split into
    ``world`` equal blocks and block j goes to rank j (a row-space
    transpose). The local row count must be divisible by the group
    size."""
    world = dist.get_world_size(group)
    if x.shape[0] % world:
        raise ValueError(f"all_to_all_rows: {x.shape[0]} local rows not "
                         f"divisible by {world} ranks")
    recv = _exchange_bytes(x, group, _xdev(group, x.device))
    return recv.to(x.device).view(x.dtype).reshape(x.shape)


def exchange_rows(staged: torch.Tensor, inv, group=None,
                  device=None) -> torch.Tensor:
    """Deliver planner-staged rows to their destination ranks.

    The device half of the device-collective fetch
    (``data/device_fetch.py``): this rank's ``staged`` send buffer holds
    ``world`` equal blocks (block j = the rows it sends to rank j,
    front-packed, padded to the plan's static per-pair capacity), and
    ``inv`` (this rank's slice of the plan's ``inv``) gathers its rows
    out of the ``world * cap`` it receives — the inverse local
    permutation that restores exact batch order and drops the padding.
    The gather (an ``index_select``) runs on ``device`` (default: where
    ``staged`` lives)."""
    dev = staged.device if device is None else torch.device(device)
    world = dist.get_world_size(group)
    if staged.shape[0] % world:
        raise ValueError(f"exchange_rows: {staged.shape[0]} staged rows "
                         f"not divisible by {world} ranks")
    dtype, item = staged.dtype, tuple(staged.shape[1:])
    recv = _exchange_bytes(staged, group, _xdev(group, dev)).to(dev)
    inv = torch.as_tensor(np.asarray(inv, dtype=np.int64)) \
        if not isinstance(inv, torch.Tensor) else inv.long()
    out = recv.index_select(0, inv.to(dev))
    return out.view(dtype).reshape((len(inv),) + item)


def _fold(*keys: int) -> int:
    """A 63-bit generator seed from integer keys (the port's stand-in
    for ``jax.random.fold_in``: same keys, same seed, on every rank)."""
    state = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def global_shuffle_epoch(x: torch.Tensor, seed: int,
                         group=None) -> torch.Tensor:
    """Device-resident global shuffle with static shapes.

    local-perm ∘ all_to_all ∘ local-perm: the inner exchange moves every
    j-th block of every rank to rank j; the outer permutations are
    independent per rank and per epoch (``seed`` folded with the rank,
    the second with ``world + rank`` as the reference folds its keys),
    so the composition mixes rows across the whole global index space.
    The permutations come from ``torch.Generator``s, not
    ``jax.random``: the same structure, not the same orders."""
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    n = x.shape[0]
    if n % world:
        raise ValueError(f"global_shuffle_epoch: {n} local rows not "
                         f"divisible by {world} ranks")
    g1 = torch.Generator().manual_seed(_fold(seed, rank))
    g2 = torch.Generator().manual_seed(_fold(seed, rank, world + rank))
    p1 = torch.randperm(n, generator=g1).to(x.device)
    p2 = torch.randperm(n, generator=g2).to(x.device)
    return all_to_all_rows(x.index_select(0, p1), group).index_select(0, p2)


def permute_rows(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """Arbitrary global row permutation of rows sharded evenly over the
    group: ``out[i] = x[perm[i]]`` across ranks; returns this rank's
    shard of ``out``. Every rank passes the same global ``perm``. An
    exchange planned by :func:`plan_device_fetch` over the shard
    boundaries (each rank stages the rows it holds, one
    ``all_to_all_single`` delivers them). Use
    :func:`global_shuffle_epoch` when any good shuffle will do (cheaper);
    use this when the exact permutation matters."""
    from ..data.device_fetch import plan_device_fetch

    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    n = x.shape[0]
    perm = np.ascontiguousarray(
        perm.cpu().numpy() if isinstance(perm, torch.Tensor) else perm,
        dtype=np.int64).reshape(-1)
    if perm.size != n * world:
        raise ValueError(f"permute_rows: a permutation of {perm.size} "
                         f"rows over {world} shards of {n}")
    starts = np.arange(world + 1, dtype=np.int64) * n
    plan = plan_device_fetch(starts, perm, world)
    pos = plan.owner_positions[rank]
    slots = plan.staged_pos[pos] - rank * world * plan.cap
    staged = x.new_zeros((world * plan.cap,) + tuple(x.shape[1:]))
    staged[torch.from_numpy(slots).to(x.device)] = x.index_select(
        0, torch.from_numpy(perm[pos] - rank * n).to(x.device))
    return exchange_rows(staged, plan.inv[rank * n:(rank + 1) * n], group)


def _shard_perm(total: int, begin: int, end: int, seed,
                rng: Optional[np.random.Generator]) -> np.ndarray:
    """perm[begin:end] of a seeded global permutation, O(end - begin)
    memory when total is large (every rank computes the SAME perm) —
    the dense-vs-Feistel policy lives in data/permute.py."""
    from ..data.permute import seeded_perm_slice
    return seeded_perm_slice(total, begin, end, seed, rng)


def _reject_ragged(store, name: str) -> None:
    """A ragged pair's {name}/index rows carry (values_start, length)
    pointers whose spans live in the SAME rank's values shard
    (store.add_ragged's locality invariant). Row-shuffling either half
    independently silently corrupts that invariant — index rows pointing
    at spans that moved, or values rows torn out of their samples. Route
    callers to ragged_global_shuffle, which moves spans with their rows."""
    base = name.rsplit("/", 1)[0] if "/" in name else name
    if name.endswith(("/index", "/values")) and store.is_ragged(base):
        raise ValueError(
            f"{name} is half of the ragged pair {base!r}; shuffling it "
            f"alone would corrupt the index->values locality invariant. "
            f"Use ragged_global_shuffle(store, {base!r}, seed).")
    if store.is_ragged(name):
        raise ValueError(
            f"{name} is a ragged variable; use ragged_global_shuffle.")


def host_global_shuffle(store, name: str, seed: int,
                        rng: Optional[np.random.Generator] = None) -> None:
    """Host-path global shuffle of a store variable, in place.

    Every rank computes the same seeded global permutation, batch-fetches
    the rows assigned to its shard (coalesced one-sided reads over the
    transport), waits at a barrier so all fetches complete against the OLD
    data, then atomically overwrites its shard. Collective: all ranks must
    call with the same seed. Index memory is O(shard) at any row count
    (blocked Feistel permutation above ``DENSE_MAX``).
    """
    _reject_ragged(store, name)
    info = store.query(name)
    total = info["total_rows"]
    begin, end = store.my_row_range(name)
    mine = _shard_perm(total, begin, end, seed, rng)
    fresh = store.get_batch(name, mine)     # reads see old data
    store.barrier()                          # everyone done reading
    store.update(name, fresh, 0)             # then everyone swaps
    store.barrier()


def ragged_global_shuffle(store, name: str, seed: int) -> None:
    """Global shuffle of a ragged variable: sample i's (index row +
    values span) move TOGETHER to wherever the permutation sends it, and
    the pair is re-registered so the locality invariant (each sample's
    elements inside its owner's values shard) holds by construction.
    Collective; same seed everywhere.
    """
    if not store.is_ragged(name):
        raise ValueError(f"{name!r} is not a ragged variable")
    total = store.ragged_total(name)
    begin, end = store.my_row_range(f"{name}/index")
    src = _shard_perm(total, begin, end, seed, rng=None)
    values, lengths = store.get_ragged_batch(name, src)  # old data
    store.barrier()                                      # all reads done
    samples = (np.split(values, np.cumsum(lengths)[:-1])
               if len(lengths) else [])
    store.free(f"{name}/values")
    store.free(f"{name}/index")
    store.add_ragged(name, samples)
