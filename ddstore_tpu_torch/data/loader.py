"""Prefetching device loader: store -> pinned host batch -> the card.

The port of ``ddstore_tpu/data/loader.py``: whole batches of indices
come from the sampler, one batched ``fetch`` gathers their rows, and an
ordered pool of worker threads keeps ``prefetch`` batches in flight
ahead of the consumer.

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

With ``device_collective=True`` (:mod:`~ddstore_tpu_torch.data.device_fetch`)
every rank reads only the rows it owns of each global batch (one local
read, on a worker thread, into a pinned send buffer copied to the card
on the copy stream), and one ``all_to_all_single`` over the process
group delivers them; that exchange runs on the consumer thread, in
batch order, the one thread that launches collectives (DDP's all-reduce
is the other). Before each exchange the ranks agree on a staged-ok flag
(one integer ``all_reduce(MIN)``), so a rank whose staging failed never
strands the others in the exchange.

Over a store that has them, the loader wires the store's counters into
``metrics.summary()`` (scatter plan, faults, failover, integrity,
tiering, live latency, SLOs, gateway, lanes) and runs the cost-model
scheduler (:mod:`~ddstore_tpu_torch.sched`): a replan at every epoch
start, after every degradation, and on peer changes; the readahead
depth it plans; the SLO and admission checks at every epoch end.
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

# Staged-ok flags the ranks agree on before an exchange (the minimum
# wins): every rank staged; some rank failed transiently (every rank
# reads the batch through the host path); some rank lost an owner
# (every rank raises).
_STAGED, _FAILED, _PEER_LOST = 1, 0, -1


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


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _PendingExchange:
    """A staged collective fetch whose exchange still needs the consumer
    thread (single-thread collective dispatch discipline)."""

    __slots__ = ("finalize",)

    def __init__(self, finalize: Callable):
        self.finalize = finalize


class DeviceLoader:
    """Iterate batches of a store-backed dataset as tensors on ``device``.

    Parameters
    ----------
    dataset: object with ``fetch(indices, out=None)`` and ``__len__``
        (e.g. :class:`ShardedDataset`), or a bare callable ``f(indices)``.
    sampler: iterable of global indices for this rank's epoch (e.g.
        :class:`DistributedSampler`). With ``device_collective`` it
        yields the GLOBAL index stream, the same on every rank
        (``DistributedSampler(n, 1, 0, ...)`` on every rank).
    batch_size: per-process batch size; with ``device_collective`` the
        global batch ``B``, of which each rank receives its
        ``B / world`` rows (rank ``r`` the ``r``-th slice).
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
        window N is consumed. This is the ceiling (and the ring budget):
        the cost-model scheduler may plan the depth shallower, and
        ``DDSTORE_READAHEAD_DEPTH`` pins it. Composes with the host path
        and with ``device_collective`` (each rank's window then holds
        only the rows it owns, read locally, and fills its send
        buffers). Needs a store-backed dataset (``store`` + fixed-width
        ``data_var``) and a sized, replayable sampler (every
        ``DistributedSampler``); otherwise the loader reads per batch
        with the reason in ``readahead_fallback_reason``.
    readahead_window_batches: window size W in batches (default 8);
        the ring holds ``readahead_windows × W × batch_size`` rows per
        variable.
    device_collective: stage batches with the device-collective fetch
        (:mod:`~ddstore_tpu_torch.data.device_fetch`): each rank reads
        only the rows of the global batch it owns (one local
        ``get_batch``) and one ``all_to_all_single`` over ``group``
        delivers every row to its destination rank — remote rows never
        cross the store's transport. Requires an initialized
        ``torch.distributed`` group whose size is the store's world, no
        host transform, a store-backed dataset exposing a fixed-width
        ``data_var``, and a global batch divisible by the world;
        anything else reads through the host path (still this rank's
        slice of each global batch) with the reason in
        ``collective_fallback_reason``.
    group: the ``torch.distributed`` process group the exchange runs on
        (default: the world).
    """

    def __init__(self, dataset, sampler: Iterable[int], batch_size: int,
                 device=None, prefetch: int = 4,
                 workers: Optional[int] = None, drop_last: bool = True,
                 transform: Optional[Callable] = None,
                 readahead_windows: int = 0,
                 readahead_window_batches: int = 8,
                 device_collective: bool = False, group=None):
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
        store = getattr(dataset, "store", None)
        self._wire_sources(store)
        # Cost-model scheduler: plans route x lanes x readahead depth x
        # async width jointly from the store's measurement cells. Made
        # even with DDSTORE_SCHED=0 (disabled, it never pins anything) so
        # summary()["sched"] always states the enablement. User env pins
        # freeze their knobs; the planner plans the rest.
        self.sched = None
        if store is not None and hasattr(store, "sched_cells"):
            from ..sched.planner import Scheduler

            nvars = 1 + (1 if getattr(dataset, "label_var", None) else 0)
            # requested_depth 0: this loader runs no readahead, and the
            # scheduler leaves the depth/width knobs (and the store's
            # other async users) alone.
            self.sched = Scheduler(store, nvars=nvars,
                                   requested_depth=int(readahead_windows))
            self.metrics.set_sched_source(self.sched.snapshot)
        self.device_collective = bool(device_collective)
        self.group = group
        self.collective_fallback_reason: Optional[str] = None
        self._share = (0, 1)  # (rank, world) of each global batch's slice
        self._collective_ready = False
        if self.device_collective:
            self._collective_ready = self._collective_usable()
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

    def _wire_sources(self, store) -> None:
        """Each per-epoch summary the store can source: the scatter
        planner, the fault/retry ledger, replicated-read failover,
        integrity, tiering, the live latency histograms, the SLO monitor,
        the serving gateway and the per-lane bytes. Each section appears
        in ``summary()`` only when its feature is in force."""
        if store is None:
            return
        m = self.metrics
        for name, setter in (("plan_stats", m.set_plan_source),
                             ("fault_stats", m.set_fault_source),
                             ("failover_stats", m.set_failover_source),
                             ("integrity_stats", m.set_integrity_source),
                             ("tiering_stats", m.set_tiering_source),
                             ("metrics_snapshot", m.set_latency_source),
                             ("slo_summary", m.set_slo_source),
                             ("gateway_stats", m.set_gateway_source),
                             ("lane_bytes", m.set_lane_source)):
            if hasattr(store, name):
                setter(getattr(store, name))

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

    def _collective_usable(self) -> bool:
        import torch.distributed as dist

        reason = None
        store = getattr(self.dataset, "store", None)
        data_var = getattr(self.dataset, "data_var", None)
        if not (dist.is_available() and dist.is_initialized()):
            reason = "no process group (torch.distributed not initialized)"
        else:
            self._share = (dist.get_rank(self.group),
                           dist.get_world_size(self.group))
            d = self._share[1]
            if self.transform is not None:
                reason = "host-side transform set"
            elif store is None or data_var is None:
                reason = "dataset exposes no store/data_var"
            elif store.is_ragged(data_var):
                reason = "ragged data_var (dataset.fetch packs samples)"
            elif d != store.world:
                reason = (f"group of {d} ranks is not the store's world "
                          f"of {store.world}")
            elif self._share[0] != store.rank:
                reason = (f"group rank {self._share[0]} is not store rank "
                          f"{store.rank}")
            elif self.batch_size % d:
                reason = (f"batch {self.batch_size} not divisible by "
                          f"{d} shards")
        if reason is not None:
            self.collective_fallback_reason = reason
            return False
        from .device_fetch import exchange_device

        self.metrics.set_collective(
            str(exchange_device(self.group, self.device)))
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

    def _my_slice(self, idx: np.ndarray) -> np.ndarray:
        """This rank's slice of a global batch (the whole batch unless
        ``device_collective``): the rows the exchange would deliver."""
        r, d = self._share
        if d == 1:
            return idx
        bounds = np.cumsum([0] + [len(p) for p in
                                  np.array_split(np.arange(len(idx)), d)])
        return idx[bounds[r]:bounds[r + 1]]

    def _owned(self, idx: np.ndarray) -> np.ndarray:
        """The rows of a global batch this rank owns, in batch order
        (``idx[plan.owner_positions[rank]]``)."""
        store = self.dataset.store
        starts = store.row_starts(self.dataset.data_var)
        return idx[np.searchsorted(starts, idx, side="right") - 1
                   == store.rank]

    def _pinned_out(self, n: int):
        """Pinned host buffers for a direct gather, or None where the
        rows cannot land in them as they are (no copy to a card, a bare
        callable, or a transform that makes new arrays)."""
        if (self._copy_stream is None or self.transform is not None
                or not hasattr(self.dataset, "specs")):
            return None
        bufs = tuple(
            torch.empty((n,) + tuple(shape), dtype=_torch_dtype(dtype),
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
        if self.sched is not None:
            # A ladder engagement is a regime change: replan (outside
            # the latch lock; the replan takes the scheduler's own).
            self.sched.on_degradation("readahead")

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
                if self.sched is not None:
                    self.sched.on_degradation("peer_lost")
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
        if self._collective_ready:
            from .device_fetch import plan_device_fetch

            try:
                plan = plan_device_fetch(
                    self.dataset.store.row_starts(self.dataset.data_var),
                    idx, self._share[1])
            except ValueError:
                # A geometry this batch cannot satisfy (a short trailing
                # batch with drop_last=False): every rank plans the same
                # batch, so every rank reads it through the host path.
                return self._fetch_host(self._my_slice(idx), seq, None)
            return self._fetch_collective(idx, seq, ra, plan)
        return self._fetch_host(self._my_slice(idx), seq, ra)

    def _fetch_host(self, idx: np.ndarray, seq: int, ra):
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

    def _fetch_collective(self, idx: np.ndarray, seq: int, ra, plan):
        """Host half of the collective staging, on a worker thread: this
        rank's local reads (or its window's rows) into pinned send
        buffers, copied to the card on the copy stream. Returns the
        thunk the consumer thread runs for the agreement and the
        exchange. A staging failure is carried to the agreement, never
        raised here: the other ranks must learn of it before they enter
        the exchange."""
        from .device_fetch import exchange_device, stage_batch

        store = self.dataset.store
        names = [self.dataset.data_var]
        label_var = getattr(self.dataset, "label_var", None)
        if label_var:
            names.append(label_var)
        d = self._share[1]
        staged, err = [], None
        with self.metrics.fetch.timed():
            try:
                rows = ra.batch_rows(seq, idx=self._owned(idx)) \
                    if ra is not None else [None] * len(names)
                for name, got in zip(names, rows):
                    shape, dtype = store.sample_spec(name)
                    n = d * plan.cap
                    buf = torch.empty(
                        (n,) + tuple(shape), dtype=_torch_dtype(dtype),
                        pin_memory=self._copy_stream is not None)
                    staged.append(stage_batch(
                        store, name, idx, d, plan=plan,
                        metrics=self.metrics, rows=got, out=buf.numpy()))
                    staged[-1].staged = buf
                xdev = exchange_device(self.group, self.device)
                if xdev.type == "cuda":
                    with torch.cuda.stream(self._copy_stream):
                        for sf in staged:
                            sf.staged = sf.staged.to(xdev,
                                                     non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(self._copy_stream)
                    event.synchronize()
            except Exception as e:  # noqa: BLE001 — agreed on below
                err = e
        return _PendingExchange(
            lambda: self._finalize_collective(idx, seq, staged, err, ra))

    def _finalize_collective(self, idx, seq, staged, err, ra):
        """Consumer thread: agree with the other ranks that every one of
        them staged this batch, then exchange; or, when some rank
        failed, read the batch through the host path on every rank
        (``ERR_PEER_LOST`` anywhere raises everywhere)."""
        import torch.distributed as dist

        from .device_fetch import exchange_device, exchange_staged

        mine = _STAGED if err is None else (
            _PEER_LOST if isinstance(err, DDStoreError)
            and err.code == ERR_PEER_LOST else _FAILED)
        # NCCL reduces on the card only; gloo's flag stays on the host.
        nccl = str(dist.get_backend(self.group)).lower() == "nccl"
        flag = torch.tensor([mine], dtype=torch.int32, device=(
            exchange_device(self.group, self.device) if nccl else "cpu"))
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        agreed = int(flag.item())
        if agreed == _STAGED:
            with self.metrics.stage.timed():
                out = [exchange_staged(sf, self.group, self.device)
                       for sf in staged]
            self.metrics.add_exchange()
            return out[0] if len(out) == 1 else tuple(out)
        if agreed == _PEER_LOST:
            if self.sched is not None:
                self.sched.on_degradation("peer_lost")
            if mine == _PEER_LOST:
                raise err
            raise DDStoreError(ERR_PEER_LOST,
                               "device-collective fetch: another rank's "
                               "staging lost an owner")
        if isinstance(err, DDStoreError) and err.code == ERR_ADMISSION:
            # Deferral, not failure: back off and read this one batch
            # through the host path, the collective machinery armed.
            self.metrics.add_fault_event(admission_deferred_batches=1)
            self._admission_backoff(err)
        else:
            why = err if err is not None else "another rank's staging failed"
            if self.collective_fallback_reason is None:
                self.collective_fallback_reason = f"degraded mid-epoch: {why}"
            self.metrics.add_fault_event(collective_batch_fallbacks=1)
            if self.sched is not None:
                self.sched.on_degradation("collective")
            if err is not None and ra is not None:
                # The engine may have failed before this batch's window
                # delivery: the rest of the epoch stages per batch.
                self._degrade_readahead(err)
        return self._fetch_host(self._my_slice(idx), seq, None)

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
        batch); None when readahead is off or fell back. Under the
        collective path it is fed the rows of each global batch this
        rank owns (its window reads stay local); with
        ``device_collective`` set but unusable, this rank's slices."""
        if not self._readahead_ready:
            return None
        from .readahead import EpochReadahead

        # Check the ring out for this iterator (restored at teardown):
        # two overlapping iterators of one loader must never share
        # staging buffers; the second allocates its own.
        ring, self._ra_ring = self._ra_ring, None
        # The depth is the scheduler's: readahead_windows is the
        # requested ceiling (and the ring budget); DDSTORE_READAHEAD_DEPTH
        # pins it.
        depth = self.readahead_windows
        if self.sched is not None:
            depth = self.sched.planned_depth(self.readahead_windows)
        batches, max_rows = self._index_batches(), None
        if self._collective_ready:
            batches = (self._owned(b) for b in batches)
            # an owned subset may hold up to the whole global batch
            max_rows = self.batch_size * self.readahead_window_batches
        elif self.device_collective:
            batches = (self._my_slice(b) for b in batches)
        return EpochReadahead(
            self.dataset.store, self.dataset.data_var, batches,
            label_var=getattr(self.dataset, "label_var", None),
            window_batches=self.readahead_window_batches,
            depth=depth, metrics=self.metrics, max_window_rows=max_rows,
            ring=ring, sched=self.sched)

    def __iter__(self):
        # Ordered worker pool: index batches are submitted in order and
        # futures consumed in submission order, so parallel fetch+stage
        # never reorders the epoch's batch stream. Early exit (break)
        # waits out in-flight fetches in the finally, after the
        # readahead engine's close() has released every in-flight read.
        self.metrics.epoch_start()
        self._ra_degraded.clear()  # fresh epoch, fresh engine
        store = getattr(self.dataset, "store", None)
        # Liveness sweep at the epoch boundary: newly suspected peers
        # fire the store's peer listeners (the scheduler replans off a
        # dead peer before this epoch's plan is applied below).
        check_health = getattr(store, "check_health", None)
        if check_health is not None:
            try:
                check_health()
            except Exception:  # noqa: BLE001 — polling never fails an epoch
                pass
        if self.sched is not None:
            # Epoch-boundary replan before the engine is built: the
            # planned depth/width govern this epoch's ring and admission,
            # and the route/lane pins land before the first fetch.
            self.sched.on_epoch()
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
                item = futs.popleft().result()
                if isinstance(item, _PendingExchange):
                    # The exchange runs here, on the consumer thread: the
                    # only thread that launches collectives (the train
                    # step is its other client).
                    item = item.finalize()
                item = self._hand_over(item)
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
            # SLO evaluation at the epoch boundary, before the metrics
            # freeze, so this epoch's summary()["slo"] carries its own
            # verdict; a breach replans the breached tenant.
            self._check_slos()
            self._check_admission_pressure()
            self.metrics.epoch_end()

    def _check_slos(self) -> None:
        """Evaluate the store's latency SLOs over the epoch that just
        ended and fire one scheduler replan per breached tenant. Inert
        while no SLO is configured; never fails the epoch."""
        store = getattr(self.dataset, "store", None)
        if store is None or not hasattr(store, "evaluate_slos"):
            return
        try:
            breaches = store.evaluate_slos()
        except Exception:  # noqa: BLE001 — observability never fails
            return
        if self.sched is not None:
            for b in breaches:
                self.sched.on_degradation(f"slo:{b['tenant']}")

    def _check_admission_pressure(self) -> None:
        """Feed the epoch's gateway deferred/rejected deltas to the
        planner as defer pressure (one replan, not one per deferral).
        Inert with the gateway off; never fails the epoch."""
        if self.sched is None:
            return
        try:
            gw = self.metrics.gateway_summary()
            deferred = int(gw.get("deferred", 0))
            rejected = int(gw.get("rejected", 0))
        except Exception:  # noqa: BLE001 — observability never fails
            return
        if deferred or rejected:
            self.sched.on_admission_pressure(deferred, rejected)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size
