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
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..utils.metrics import PipelineMetrics

__all__ = ["DeviceLoader"]


def _tree_map(fn, x):
    if isinstance(x, tuple):
        return tuple(_tree_map(fn, v) for v in x)
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

    ``readahead_windows`` and ``device_collective`` belong to later
    slices of the port and raise ``NotImplementedError`` when set.
    """

    def __init__(self, dataset, sampler: Iterable[int], batch_size: int,
                 device=None, prefetch: int = 4,
                 workers: Optional[int] = None, drop_last: bool = True,
                 transform: Optional[Callable] = None,
                 readahead_windows: int = 0,
                 device_collective: bool = False):
        if readahead_windows:
            raise NotImplementedError(
                "readahead_windows: epoch-window readahead is not ported "
                "yet")
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

    def _fetch(self, idx: np.ndarray):
        pinned = self._pinned_out(len(idx))
        with self.metrics.fetch.timed():
            if callable(self.dataset):
                batch = self.dataset(idx)
            elif pinned is not None:
                self.dataset.fetch(
                    idx, out=_tree_map(lambda t: t.numpy(), pinned))
                batch = pinned
            else:
                batch = self.dataset.fetch(idx)
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

    def __iter__(self):
        # Ordered worker pool: index batches are submitted in order and
        # futures consumed in submission order, so parallel fetch+stage
        # never reorders the epoch's batch stream. Early exit (break)
        # waits out in-flight fetches in the finally.
        self.metrics.epoch_start()
        ex = ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="ddstore-torch-loader")
        futs = deque()
        try:
            it = self._index_batches()
            for idx in itertools.islice(it, self.prefetch):
                futs.append(ex.submit(self._fetch, idx))
            while futs:
                t0 = time.perf_counter()
                item = self._hand_over(futs.popleft().result())
                self.metrics.wait.record(time.perf_counter() - t0)
                nxt = next(it, None)
                if nxt is not None:
                    futs.append(ex.submit(self._fetch, nxt))
                yield item
        finally:
            for f in futs:
                f.cancel()
            ex.shutdown(wait=True)
            self.metrics.epoch_end()

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size
