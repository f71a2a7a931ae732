"""Checkpoint / resume (the port of ``ddstore_tpu/utils/checkpoint.py``):
train state through ``torch.save``, store shards through raw files.

* :func:`save_train_state` / :func:`restore_train_state` — a nested
  dict (or list, tuple) of tensors and plain values, typically
  ``{"model": model.state_dict(), "opt": opt.state_dict()}``, written
  with ``torch.save`` (atomically: a temporary file renamed over the
  target) and read back onto the host; each tensor that has a
  counterpart in the ``like`` structure then takes its device and
  dtype, and the rest (an optimizer's state) is left for
  ``load_state_dict`` to place by its own policy.
* :func:`save_train_state_async` — the same write without blocking the
  train loop. Torch optimizers update parameters IN PLACE (the JAX
  package's arrays are immutable, so its async save may read them
  later), so the device-to-host snapshot is taken and completed before
  the call returns; only serialization runs on the background thread.
  A step taken right after the call never reaches the file.
* :func:`save_shard` / :func:`load_shard` — a store variable's LOCAL
  shard to/from ``<dir>/<name>.r<rank>.bin`` plus a JSON sidecar, the
  JAX package's format byte for byte (either package loads the other's
  files); restore is a collective ``add`` (or an mmap-backed
  ``add_mmap`` in tiered mode), and a checkpoint written by one world
  size reloads on another (elastic re-split).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_train_state", "save_train_state_async",
           "restore_train_state", "save_shard", "load_shard"]


def _map(fn, obj):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples;
    every other leaf is kept as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map(fn, v) for v in obj)
    return obj


def _host_snapshot(state: Any) -> Any:
    """A host copy of every tensor of ``state``, complete on return.
    Card tensors are copied into pinned buffers on the current stream
    (after every kernel already queued there, the optimizer step that
    wrote them included) and fenced by one event."""
    on_card = []

    def copy(t):
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            on_card.append(t.device)
            return host
        return t.clone()

    host = _map(copy, state)
    if on_card:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(on_card[0]))
        event.synchronize()
    return host


def _write(path: str, host_state: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    torch.save(host_state, tmp)
    os.replace(tmp, path)


def save_train_state(path: str, state: Any) -> None:
    """Write ``state`` to the file ``path`` (blocking)."""
    _write(path, _host_snapshot(state))


class AsyncSave:
    """Handle for an in-flight async checkpoint: ``wait()`` blocks until
    the file is written (and raises what the write raised). Call it
    before the next save to the same path and before process exit."""

    def __init__(self, path: str, host_state: Any):
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(path, host_state), daemon=True,
            name="ddstore-ckpt-save")
        self._thread.start()

    def _run(self, path: str, host_state: Any) -> None:
        try:
            _write(path, host_state)
        except BaseException as e:  # noqa: BLE001 — raised by wait()
            self.error = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self) -> None:
        self._thread.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()


def save_train_state_async(path: str, state: Any) -> AsyncSave:
    """Start writing ``state`` to ``path`` WITHOUT blocking the train
    loop: the host snapshot is complete when this returns (so the next
    in-place optimizer step cannot leak into the file), and
    ``torch.save`` runs on a background thread. Use the handle's
    ``wait()`` (or the handle as a context manager)."""
    return AsyncSave(path, _host_snapshot(state))


def _check_like(got: Any, like: Any, where: str = "state") -> None:
    """The restored structure must hold ``like``'s keys, and its tensors
    ``like``'s shapes (an empty ``like`` container, such as an optimizer
    that has not stepped yet, takes whatever was saved)."""
    if isinstance(like, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != like.shape:
            raise ValueError(f"{where}: checkpoint holds "
                             f"{getattr(got, 'shape', type(got))}, "
                             f"expected a tensor of shape "
                             f"{tuple(like.shape)}")
    elif isinstance(like, dict) and like:
        if not isinstance(got, dict) or set(got) != set(like):
            raise ValueError(f"{where}: checkpoint keys "
                             f"{sorted(map(str, got))} != "
                             f"{sorted(map(str, like))}")
        for k in like:
            _check_like(got[k], like[k], f"{where}[{k!r}]")
    elif isinstance(like, (list, tuple)) and like:
        if not isinstance(got, (list, tuple)) or len(got) != len(like):
            raise ValueError(f"{where}: checkpoint length differs")
        for i, (g, l) in enumerate(zip(got, like)):
            _check_like(g, l, f"{where}[{i}]")


def restore_train_state(path: str, like: Any) -> Any:
    """Read a checkpoint and check it against ``like``'s structure (pass
    the freshly created state). A tensor with a counterpart tensor in
    ``like`` takes that tensor's device and dtype; every other tensor
    stays on the host. So a fresh optimizer's empty state takes the
    saved one as it is, and ``optimizer.load_state_dict`` places it as
    the optimizer would have: Adam's moments on the parameters' device,
    its ``step`` counts on the host (unless it is capturable or fused).
    Returns the restored structure; load it with ``load_state_dict``."""
    got = torch.load(os.path.abspath(path), map_location="cpu",
                     weights_only=True)
    _check_like(got, like)

    def cast(g, l):
        if isinstance(l, torch.Tensor):
            return g.to(device=l.device, dtype=l.dtype)
        if isinstance(l, dict) and isinstance(g, dict):
            return {k: cast(v, l.get(k)) for k, v in g.items()}
        if isinstance(l, (list, tuple)) and isinstance(g, (list, tuple)) \
                and len(l) == len(g):
            return type(g)(cast(a, b) for a, b in zip(g, l))
        return g

    return cast(got, like)


def save_shard(store, name: str, directory: str,
               chunk_rows: int = 65536) -> str:
    """Write this rank's shard of ``name`` to ``<dir>/<name>.r<rank>.bin``
    with a JSON sidecar. Local-only IO; call on every rank.

    Every rank first removes rank files in ITS directory that the
    CURRENT world cannot produce (rank index >= world). Without this, a
    save at a smaller world leaves sidecars from an earlier larger-world
    save behind, and a later resume at that larger world would silently
    mix generations: ranks whose stale file "matches" their rank load
    old bytes while the rest re-shard the new ones. Only files no live
    rank owns are unlinked (``.w*`` elastic-restore scratch is spared —
    a peer may hold a live mmap on it — and is never read by
    :func:`load_shard`), so this cannot race concurrent writes; on a
    shared dir the ranks' unlinks race only each other (idempotent).
    Caveat: with NODE-LOCAL directories, files on nodes that left the
    job can obviously not be cleaned — shrink-then-regrow resumes need
    a shared directory (or empty dirs on the regrown nodes) to be safe;
    :func:`load_shard` detects the mix via rank 0's sidecar only when
    it can see it."""
    m = store._require(name)
    begin, end = store.my_row_range(name)
    os.makedirs(directory, exist_ok=True)
    _unlink_stale(directory, name, store.world)
    stem = _stem(directory, name, store.rank)
    with open(stem + ".bin", "wb") as f:
        for s in range(begin, end, chunk_rows):
            store.get(name, s, min(chunk_rows, end - s)).tofile(f)
    with open(stem + ".json", "w") as f:
        json.dump({"dtype": m.dtype.str, "sample_shape": list(m.sample_shape),
                   "nrows": end - begin, "rank": store.rank,
                   "world": store.world}, f)
    return stem + ".bin"


def _stem(directory: str, name: str, rank: int) -> str:
    return os.path.join(directory, f"{name.replace('/', '_')}.r{rank}")


def _unlink_stale(directory: str, name: str, world: int) -> None:
    """Remove checkpoint rank files for ``name`` with rank index >=
    ``world`` — files the current world can never rewrite. ``.w*``
    elastic-restore scratch is deliberately NOT touched: a live rank may
    be mmap-ing it as its tiered backing file (unlink under a remote
    NFS mmap risks SIGBUS), and load_shard never reads ``.w*`` paths,
    so stale ones are inert."""
    import re

    prefix = re.escape(name.replace("/", "_"))
    pat = re.compile(rf"^{prefix}\.r(\d+)\.(bin|json)$")
    for fn in os.listdir(directory):
        mm = pat.match(fn)
        if mm and int(mm.group(1)) >= world:
            try:
                os.unlink(os.path.join(directory, fn))
            except FileNotFoundError:
                pass


def load_shard(store, name: str, directory: str, *,
               mmap: bool = False, rank: Optional[int] = None) -> None:
    """Collective: re-register ``name`` from files written by
    :func:`save_shard`. ``mmap=True`` restores in tiered (file-backed,
    read-only) mode; otherwise the shard is copied back into RAM.
    ``rank`` overrides which rank's file this process loads.

    **Elastic resume**: when the checkpoint was written by a DIFFERENT
    world size (the sidecars record it), each rank re-partitions the
    saved global row space with the same ``nsplit`` rule the dataset
    layer uses and reads exactly its byte ranges out of whichever saved
    files cover them — train on 4 ranks, crash, resume on 2 (or 8) and
    every global row is served unchanged. (Explicit ``rank=`` keeps the
    manual override and skips the re-split.)
    """
    r = store.rank if rank is None else rank
    stem = _stem(directory, name, r)
    if rank is None:
        # Every sidecar records the world it was saved under. Rank 0's
        # is AUTHORITATIVE — rank 0 participates in every save, so on a
        # shared dir its sidecar is always the latest generation, while
        # this rank's own file could be a stale leftover that
        # save_shard's cleanup predates. Fall back to the own sidecar
        # only when r0's is absent (node-local, non-shared dirs).
        probe = _stem(directory, name, 0)
        if not os.path.exists(probe + ".json"):
            probe = stem
        with open(probe + ".json") as f:
            saved_world = json.load(f)["world"]
        if saved_world != store.world:
            _load_shard_resharded(store, name, directory, saved_world,
                                  mmap=mmap)
            return
    with open(stem + ".json") as f:
        meta = json.load(f)
    if rank is None and meta["world"] != store.world:
        # Own sidecar from a different generation than rank 0's: mixed
        # checkpoint directory. Refusing beats serving stale bytes.
        raise RuntimeError(
            f"{stem}.json was saved at world={meta['world']} but rank 0's"
            f" sidecar says world={store.world}: mixed checkpoint "
            f"generations in {directory}")
    dtype = np.dtype(meta["dtype"])
    sample_shape = tuple(meta["sample_shape"])
    if mmap:
        store.add_mmap(name, stem + ".bin", dtype, sample_shape)
    else:
        nrows = meta["nrows"]
        arr = (np.fromfile(stem + ".bin", dtype=dtype)
               .reshape((nrows,) + sample_shape)) if nrows else \
            np.empty((0,) + sample_shape, dtype)
        store.add(name, arr)


def _load_shard_resharded(store, name: str, directory: str,
                          saved_world: int, *, mmap: bool) -> None:
    """Re-split a saved checkpoint across the CURRENT world size: this
    rank's target row range (same near-equal contiguous split the
    dataset adapter uses) is assembled from the saved files that overlap
    it — np.memmap reads touch only the needed pages, so a resume moves
    each byte once."""
    from ..data.dataset import nsplit

    metas = []
    for i in range(saved_world):
        with open(_stem(directory, name, i) + ".json") as f:
            metas.append(json.load(f))
        if metas[-1]["world"] != saved_world:
            # A sidecar from a different save generation (e.g. a save
            # that died between ranks): assembling it with the others
            # would serve rows from two checkpoints as one dataset.
            raise RuntimeError(
                f"{_stem(directory, name, i)}.json was saved at world="
                f"{metas[-1]['world']} but rank 0's sidecar says world="
                f"{saved_world}: mixed checkpoint generations in "
                f"{directory}")
    dtype = np.dtype(metas[0]["dtype"])
    sample_shape = tuple(metas[0]["sample_shape"])
    total = sum(m["nrows"] for m in metas)
    counts = nsplit(total, store.world)
    begin = int(sum(counts[: store.rank]))
    end = begin + counts[store.rank]

    arr = np.empty((end - begin,) + sample_shape, dtype)
    file_start = 0
    for i, m in enumerate(metas):
        fs, fe = file_start, file_start + m["nrows"]
        file_start = fe
        lo, hi = max(begin, fs), min(end, fe)
        if lo >= hi:
            continue
        src = np.memmap(_stem(directory, name, i) + ".bin", dtype=dtype,
                        mode="r", shape=(m["nrows"],) + sample_shape)
        arr[lo - begin:hi - begin] = src[lo - fs:hi - fs]
        del src
    if mmap:
        # Tiered restore across a world change: the re-split rows must
        # live in ONE backing file per rank; write it next to the saved
        # ones (suffixed by the new world so reruns don't collide) and
        # map that.
        stem = _stem(directory, name, store.rank) + f".w{store.world}"
        arr.tofile(stem + ".bin")
        del arr
        store.add_mmap(name, stem + ".bin", dtype, sample_shape)
    else:
        store.add(name, arr)
