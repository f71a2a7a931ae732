"""Prefetching device loader: store -> pinned host batch -> the card.

The port of ``ddstore_tpu/data/loader.py``'s host path: whole batches of
indices come from the sampler, one batched ``fetch`` gathers their rows,
and an ordered pool of worker threads keeps ``prefetch`` batches in
flight ahead of the consumer.

Staging replaces ``jax.make_array_from_process_local_data``
(``loader.py:540-547``): a store-backed batch is gathered straight into
a pinned host buffer, copied with ``.to(device, non_blocking=True)`` on a
dedicated CUDA stream, and fenced with an event that the worker thread
waits on, so the consumer gets tensors whose copy has completed. Staging
time (gather to pinned excluded, copy to the card included) goes into
``metrics.stage`` and the consumer's wait into ``metrics.wait``.

Over a multi-process store the rows of other ranks arrive over the
native transport straight into the pinned buffer (``get_batch(out=)``);
their bytes go into ``metrics.bytes_moved()["bytes_over_dcn"]``. A lost
owner (``ERR_PEER_LOST``) surfaces from the iterator; a serving gateway's
admission refusal (``ERR_ADMISSION``) is flow control, not failure: the
batch backs off for the gateway's retry-after hint, with jitter seeded
from ``DDSTORE_FAULT_SEED``, and is read again, at most
``DDSTORE_GW_RETRY_MAX`` (default 8) times.

With ``readahead_windows=K`` the epoch's reads are planned a window of
batches at a time and fetched in bulk through the native async engine
(:mod:`~ddstore_tpu_torch.data.readahead`); each batch is then a gather
from the staged window, straight into the pinned buffer. A window that
fails even its per-batch retry degrades the rest of the epoch to the
per-batch path (``readahead_fallback_reason``); ``ERR_PEER_LOST`` still
surfaces.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..binding import ERR_ADMISSION, ERR_PEER_LOST, DDStoreError
from ..utils.metrics import PipelineMetrics
from .device_fetch import host_bytes_over_dcn

__all__ = ["DeviceLoader"]


def _tree_map(fn, x):
    """``fn`` over the leaves of nested tuples, lists and dicts, keeping
    each container's type (a named tuple such as ``GraphBatch`` stays
    one)."""
    if isinstance(x, tuple):
        vals = [_tree_map(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x):
    out = []
    _tree_map(out.append, x)
    return out


class DeviceLoader:
    """Iterate batches of a store-backed dataset as tensors on ``device``.

    Parameters
    ----------
    dataset: object with ``fetch(indices, out=None)`` and ``__len__``
        (e.g. :class:`ShardedDataset`), or a bare callable ``f(indices)``.
    sampler: iterable of global indices for this rank's epoch (e.g.
        :class:`DistributedSampler`).
    batch_size: per-process batch size.
    device: where batches land: ``"cuda"`` (the default) or ``"cpu"``.
    prefetch: batches kept in flight ahead of the consumer.
    workers: fetch+stage threads; default 2 for store-backed datasets,
        1 for a bare callable unless it declares ``thread_safe = True``.
    drop_last: drop the trailing partial batch.
    transform: optional host-side function applied to each fetched numpy
        batch (serialized under a lock when there are several workers).
    readahead_windows: > 0 enables epoch-window readahead
        (:mod:`~ddstore_tpu_torch.data.readahead`): the sampler's epoch
        is sliced into windows of ``readahead_window_batches`` batches,
        each window's rows fetched as one sorted, deduplicated bulk read
        per variable through the native async engine into a staging
        ring of this many buffers, so window N+1 is in flight while
        window N is consumed. The depth is the value given (the
        reference's scheduler may plan it shallower; that comes with
        the scheduler, ROADMAP item 17). Needs a store-backed dataset
        (``store`` + fixed-width ``data_var``) and a sized, replayable
        sampler (every ``DistributedSampler``); otherwise the loader
        reads per batch with the reason in
        ``readahead_fallback_reason``.
    readahead_window_batches: window size W in batches (default 8);
        the ring holds ``readahead_windows × W × batch_size`` rows per
        variable.

    ``device_collective`` belongs to a later slice of the port and
    raises ``NotImplementedError`` when set.
    """

    def __init__(self, dataset, sampler: Iterable[int], batch_size: int,
                 device=None, prefetch: int = 4,
                 workers: Optional[int] = None, drop_last: bool = True,
                 transform: Optional[Callable] = None,
                 readahead_windows: int = 0,
                 readahead_window_batches: int = 8,
                 device_collective: bool = False):
        if device_collective:
            raise NotImplementedError(
                "device_collective: the NCCL collective fetch is not "
                "ported yet")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.prefetch = max(1, int(prefetch))
        if workers is None:
            fetch_safe = getattr(dataset, "thread_safe",
                                 not callable(dataset))
            workers = 2 if fetch_safe else 1
        self.workers = max(1, int(workers))
        self.drop_last = drop_last
        self.transform = transform
        self._transform_lock = threading.Lock()
        self.metrics = PipelineMetrics()
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._admission_rng = random.Random(
            int(os.environ.get("DDSTORE_FAULT_SEED", "0") or 0))
        self._admission_mu = threading.Lock()
        self._admission_retries = int(
            os.environ.get("DDSTORE_GW_RETRY_MAX", "8") or 8)
        self.readahead_windows = max(0, int(readahead_windows))
        self.readahead_window_batches = max(1,
                                            int(readahead_window_batches))
        self.readahead_fallback_reason: Optional[str] = None
        # Staging ring handed from epoch to epoch (reallocating and
        # refaulting the window buffers every epoch costs real time).
        self._ra_ring = None
        self._readahead_ready = (self.readahead_windows > 0
                                 and self._readahead_usable())
        # Mid-epoch degradation latch: once a window fails even its
        # per-batch retry (a transient failure; a lost owner raises),
        # every worker of this epoch reads per batch. Reset per epoch.
        # The lock makes latch-and-count one step for racing workers.
        self._ra_degraded = threading.Event()
        self._ra_degrade_mu = threading.Lock()

    def _readahead_usable(self) -> bool:
        store = getattr(self.dataset, "store", None)
        data_var = getattr(self.dataset, "data_var", None)
        reason = None
        if store is None or data_var is None:
            reason = "dataset exposes no store/data_var"
        elif store.is_ragged(data_var):
            # The engine itself handles ragged windows, but a ragged
            # dataset's fetch() does sample packing the loader cannot
            # reproduce from raw rows — per-batch path keeps it exact.
            reason = "ragged data_var (dataset.fetch packs samples)"
        elif not hasattr(self.sampler, "__len__"):
            reason = "sampler is not sized"
        elif iter(self.sampler) is self.sampler:
            reason = ("sampler is a one-shot iterator (readahead "
                      "replays the epoch; two iterations must yield "
                      "identical indices)")
        if reason is not None:
            self.readahead_fallback_reason = reason
            return False
        return True

    # -- internals ---------------------------------------------------------

    def _index_batches(self) -> Iterator[np.ndarray]:
        it = iter(self.sampler)
        while True:
            idx = list(itertools.islice(it, self.batch_size))
            if not idx:
                return
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield np.asarray(idx, dtype=np.int64)

    def _pinned_out(self, n: int):
        """Pinned host buffers for a direct gather, or None where the
        rows cannot land in them as they are (no copy to a card, a bare
        callable, or a transform that makes new arrays)."""
        if (self._copy_stream is None or self.transform is not None
                or not hasattr(self.dataset, "specs")):
            return None
        bufs = tuple(
            torch.empty((n,) + tuple(shape),
                        dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                        pin_memory=True)
            for shape, dtype in self.dataset.specs())
        return bufs[0] if len(bufs) == 1 else bufs

    def _admission_backoff(self, e: DDStoreError) -> None:
        """One sleep for the gateway's retry-after hint (1 ms to 1 s),
        times a seeded jitter in [0.5, 1.5)."""
        hint_ms = int(getattr(e, "retry_after_ms", 0) or 0)
        sleep_s = min(max(hint_ms, 1), 1000) / 1000.0
        with self._admission_mu:
            sleep_s *= 0.5 + self._admission_rng.random()
        time.sleep(sleep_s)

    def _record_host_dcn(self, idx: np.ndarray) -> None:
        """Rows owned by other ranks crossed the network (labels too)."""
        store = getattr(self.dataset, "store", None)
        if store is None or not hasattr(self.dataset, "data_var"):
            return
        names = [self.dataset.data_var, self.dataset.label_var]
        self.metrics.add_bytes(bytes_over_dcn=sum(
            host_bytes_over_dcn(store, v, idx) for v in names if v))

    def _degrade_readahead(self, e: BaseException) -> None:
        """Latch the epoch's readahead degradation (first failure wins
        among racing workers) and record the reason."""
        with self._ra_degrade_mu:
            if self._ra_degraded.is_set():
                return
            self._ra_degraded.set()
            self.readahead_fallback_reason = f"degraded mid-epoch: {e}"
            self.metrics.add_fault_event(readahead_degraded=1)

    def _read_window(self, idx: np.ndarray, seq: int, ra, pinned):
        """Batch ``seq`` gathered from its staged window (into
        ``pinned`` when given), or None when this batch must be read
        per batch. The engine recorded the window's bytes over the wire
        once, dedup included."""
        out = None if pinned is None else \
            _tree_map(lambda t: t.numpy(), pinned)
        try:
            batch = ra.get_batch(seq, idx=idx, out=out)
        except DDStoreError as e:
            if e.code == ERR_PEER_LOST:
                raise
            if e.code == ERR_ADMISSION:
                # Flow control: back off, read this one batch per batch,
                # and leave the engine armed for the rest of the epoch.
                self.metrics.add_fault_event(admission_deferred_batches=1)
                self._admission_backoff(e)
            else:
                self._degrade_readahead(e)
            return None
        return pinned if pinned is not None else batch

    def _read(self, idx: np.ndarray, pinned):
        if callable(self.dataset):
            return self.dataset(idx)
        for attempt in itertools.count():
            try:
                if pinned is None:
                    batch = self.dataset.fetch(idx)
                else:
                    self.dataset.fetch(
                        idx, out=_tree_map(lambda t: t.numpy(), pinned))
                    batch = pinned
                break
            except DDStoreError as e:
                if e.code != ERR_ADMISSION or \
                        attempt >= self._admission_retries:
                    raise  # ERR_PEER_LOST and the rest surface as they are
                self.metrics.add_fault_event(admission_deferred_batches=1)
                self._admission_backoff(e)
        self._record_host_dcn(idx)
        return batch

    def _fetch(self, idx: np.ndarray, seq: int = 0, ra=None):
        if ra is not None and self._ra_degraded.is_set():
            ra = None
        pinned = self._pinned_out(len(idx))
        with self.metrics.fetch.timed():
            batch = None
            if ra is not None:
                batch = self._read_window(idx, seq, ra, pinned)
            if batch is None:
                batch = self._read(idx, pinned)
        if self.transform is not None:
            with self._transform_lock:
                batch = self.transform(batch)
        return self._stage(batch)

    def _stage(self, batch):
        with self.metrics.stage.timed():
            host = _tree_map(
                lambda x: x if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x)), batch)
            if self._copy_stream is None:
                return host
            with torch.cuda.stream(self._copy_stream):
                dev = _tree_map(
                    lambda t: (t if t.is_pinned() else t.pin_memory()).to(
                        self.device, non_blocking=True), host)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            # The worker, not the consumer, waits for the copy (the one
            # fence), and the stage time is the copy's, not its enqueue's.
            event.synchronize()
        return dev

    def _hand_over(self, batch):
        """Tell the allocator that the consumer's stream now uses a batch
        the copy stream made, so its memory outlives the consumer's work
        on it. The copy itself has completed in the worker."""
        if self._copy_stream is not None:
            stream = torch.cuda.current_stream(self.device)
            for t in _leaves(batch):
                t.record_stream(stream)
        return batch

    def _make_readahead(self):
        """The epoch's readahead engine over a second, independent replay
        of the sampler (the engine checks both replays agree batch by
        batch); None when readahead is off or fell back."""
        if not self._readahead_ready:
            return None
        from .readahead import EpochReadahead

        # Check the ring out for this iterator (restored at teardown):
        # two overlapping iterators of one loader must never share
        # staging buffers; the second allocates its own.
        ring, self._ra_ring = self._ra_ring, None
        return EpochReadahead(
            self.dataset.store, self.dataset.data_var,
            self._index_batches(),
            label_var=getattr(self.dataset, "label_var", None),
            window_batches=self.readahead_window_batches,
            depth=self.readahead_windows, metrics=self.metrics, ring=ring)

    def __iter__(self):
        # Ordered worker pool: index batches are submitted in order and
        # futures consumed in submission order, so parallel fetch+stage
        # never reorders the epoch's batch stream. Early exit (break)
        # waits out in-flight fetches in the finally, after the
        # readahead engine's close() has released every in-flight read.
        self.metrics.epoch_start()
        self._ra_degraded.clear()  # fresh epoch, fresh engine
        ex = ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="ddstore-torch-loader")
        futs = deque()
        ra = self._make_readahead()
        try:
            it = enumerate(self._index_batches())
            for seq, idx in itertools.islice(it, self.prefetch):
                futs.append(ex.submit(self._fetch, idx, seq, ra))
            while futs:
                t0 = time.perf_counter()
                item = self._hand_over(futs.popleft().result())
                self.metrics.wait.record(time.perf_counter() - t0)
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(ex.submit(self._fetch, nxt[1], nxt[0],
                                          ra))
                yield item
        finally:
            for f in futs:
                f.cancel()
            if ra is not None:
                # Wake any worker blocked on a window BEFORE joining the
                # pool: shutdown(wait=True) on a worker waiting for a
                # ring slot that will never free would deadlock.
                ra.close()
                self._ra_ring = ra.ring  # reused next epoch
            ex.shutdown(wait=True)
            self.metrics.epoch_end()

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size
