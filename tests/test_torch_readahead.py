"""The port's epoch-window readahead (``data/readahead.py`` and the
loader's ``readahead_windows``) against the JAX package's and against
per-batch reads: the planner's rows, gather map, bounds and runs equal
the reference's; every windowed batch is byte-identical to per-batch
``get_batch``/``get_ragged_batch`` (duplicates, ragged windows, several
owners, consumers that finish out of order); an issuer error releases
the reads already in flight; a sampler replay that diverges raises;
loader epochs at depths 1-3 equal the host path's, and a cancelled
epoch leaves ``async_pending() == 0``; the fallback reasons are the
reference's word for word; with the store's hot-row cache armed, windows
are warmed ahead and evicted once consumed. Exact equality throughout."""

import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import ddstore_tpu as ref
from ddstore_tpu.data import readahead as rra
from ddstore_tpu_torch import rendezvous as rdv
from ddstore_tpu_torch.data import readahead as tra
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.store import DDStore
from ddstore_tpu_torch.utils.metrics import PipelineMetrics
from torch_workers import run_threads

pytestmark = pytest.mark.tier1_required

STARTS = np.array([0, 10, 30, 64], np.int64)  # 3 owners, uneven shards
PLANS = {
    "duplicates": [np.array([5, 3, 3, 12]), np.array([13, 11, 63, 5])],
    "owner boundary": [np.array([29, 30])],
    "across batches": [np.array([5, 7, 5]), np.array([5, 9])],
    "random": [np.random.default_rng(0).integers(0, 64, 16)
               for _ in range(5)],
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_window_matches_reference(case):
    got = tra.plan_window(STARTS, PLANS[case])
    want = rra.plan_window(STARTS, PLANS[case])
    for field in ("rows", "gather", "bounds", "owner", "run_starts",
                  "runs_per_peer"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.n_runs, got.dup_rows, got.n_requested, got.n_batches) == \
        (want.n_runs, want.dup_rows, want.n_requested, want.n_batches)
    for b in range(got.n_batches):
        np.testing.assert_array_equal(got.rows[got.batch_slice(b)],
                                      PLANS[case][b])


def test_epoch_windows_and_bad_input_match_reference():
    batches = [np.arange(i, i + 4) for i in range(5)]
    got = tra.plan_epoch_windows(STARTS, iter(batches), 2)
    want = rra.plan_epoch_windows(STARTS, iter(batches), 2)
    assert [p.n_batches for p in got] == [p.n_batches for p in want] == \
        [2, 2, 1]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.bounds, b.bounds)
    with pytest.raises(ValueError):
        tra.plan_window(STARTS, [])
    with pytest.raises(IndexError):
        tra.plan_window(STARTS, [np.array([64])])
    with pytest.raises(ValueError):
        tra.plan_epoch_windows(STARTS, [np.arange(4)], 0)


def test_fixed_width_duplicates_and_pinned_out():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 5)).astype(np.float32)
    labels = np.arange(300, dtype=np.int32)
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, data, labels)
        batches = [rng.integers(0, 300, size=32) for _ in range(7)]
        m = PipelineMetrics()
        with tra.EpochReadahead(s, ds.data_var, iter(batches),
                                label_var=ds.label_var, window_batches=3,
                                depth=2, metrics=m) as ra:
            for i, b in enumerate(batches):
                if i % 2:
                    x, y = ra.get_batch(i, idx=b)
                else:  # rows gathered straight into the caller's buffers
                    out = (np.empty((32, 5), np.float32),
                           np.empty((32,), np.int32))
                    x, y = ra.get_batch(i, idx=b, out=out)
                    assert x is out[0] and y is out[1]
                np.testing.assert_array_equal(x, s.get_batch(ds.data_var, b))
                np.testing.assert_array_equal(y, labels[b])
        assert s.async_pending() == 0
        ras = m.readahead_summary()
        assert ras["windows"] == 3 and ras["dup_rows"] > 0
        assert ras["rows_requested"] == 7 * 32


def test_ragged_windows():
    rng = np.random.default_rng(1)
    samples = [np.full((i % 5 + 1, 2), i, np.float32) for i in range(30)]
    samples[4] = np.zeros((0, 2), np.float32)
    with DDStore(backend="local") as s:
        s.add_ragged("g", samples)
        batches = [rng.integers(0, 30, size=8) for _ in range(5)]
        with tra.EpochReadahead(s, "g", iter(batches), window_batches=2,
                                depth=2) as ra:
            for i, b in enumerate(batches):
                v, l = ra.get_batch(i, idx=b)
                wv, wl = s.get_ragged_batch("g", b)
                np.testing.assert_array_equal(l, wl)
                np.testing.assert_array_equal(v, wv)
        assert s.async_pending() == 0


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_multi_owner_rank_stamp(backend):
    """4 owners: every windowed row arrives stamped with its owner, the
    same bytes as per-batch reads and as the reference engine's over the
    reference store."""
    world, rows = 4, 64
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, world * rows, size=16) for _ in range(6)]
    out = {}
    for key, mod, make, eng in (("ref", ref, ref.DDStore, rra),
                                ("port", rdv, DDStore, tra)):
        name = uuid.uuid4().hex

        def body(rank, mod=mod, make=make, eng=eng):
            g = mod.ThreadGroup(name, rank, world)
            with make(g, backend=backend) as s:
                s.add("v", (np.arange(rows) + rank * rows).astype(
                    np.float64).reshape(rows, 1))
                s.barrier()
                got = None
                if rank == 0:
                    m = PipelineMetrics() if eng is tra else None
                    with eng.EpochReadahead(s, "v", iter(batches),
                                            window_batches=2, depth=2,
                                            metrics=m) as ra:
                        got = [ra.get_batch(i, idx=b)
                               for i, b in enumerate(batches)]
                    for b, x in zip(batches, got):
                        np.testing.assert_array_equal(x,
                                                      s.get_batch("v", b))
                    assert s.async_pending() == 0
                    if m is not None:
                        ras = m.readahead_summary()
                        assert ras["peer_lists"] > 0
                        assert ras["remote_runs"] > 0
                        assert m.bytes_moved()["bytes_over_dcn"] > 0
                s.barrier()
                return got

        out[key] = run_threads(world, body)[0]
    for a, b in zip(out["port"], out["ref"]):
        assert a.tobytes() == b.tobytes()


def test_out_of_order_consumers_recycle_slots_safely():
    """Concurrent consumers can finish window w+1's gathers before window
    w's last one; the ring must never hand window w+depth a slot whose
    previous owner is still live."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(256, 4)).astype(np.float32)
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, data)
        for _ in range(10):
            batches = [rng.integers(0, 256, size=32) for _ in range(8)]
            with tra.EpochReadahead(s, ds.data_var, iter(batches),
                                    window_batches=2, depth=2) as ra, \
                    ThreadPoolExecutor(max_workers=3) as ex:
                futs = [ex.submit(ra.get_batch, i, b)
                        for i, b in enumerate(batches)]
                for i, f in enumerate(futs):
                    np.testing.assert_array_equal(f.result(),
                                                  data[batches[i]])
        assert s.async_pending() == 0


def test_issuer_error_releases_inflight_reads():
    """A window whose second variable fails at issue time, after the
    first variable's read went in flight, must not leak that read."""
    data = np.zeros((64, 2), np.float32)
    labels = np.arange(64, dtype=np.int32)
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, data, labels)
        orig = s.read_runs_async
        calls = {"n": 0}

        def flaky(name, *a, **k):
            calls["n"] += 1
            if calls["n"] == 2:  # the label variable of window 0
                raise RuntimeError("boom")
            return orig(name, *a, **k)

        s.read_runs_async = flaky
        ra = tra.EpochReadahead(s, ds.data_var, iter([np.arange(8)]),
                                label_var=ds.label_var, window_batches=1)
        with pytest.raises(RuntimeError, match="boom"):
            ra.get_batch(0)
        ra.close()
        assert s.async_pending() == 0


def test_replay_divergence_raises():
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, np.zeros((64, 2), np.float32))
        with tra.EpochReadahead(s, ds.data_var, iter([np.arange(8)]),
                                window_batches=1) as ra:
            with pytest.raises(RuntimeError, match="replay"):
                ra.get_batch(0, idx=np.arange(8) + 1)
        assert s.async_pending() == 0


def _epoch(ds, epoch=3, **kw):
    samp = DistributedSampler(len(ds), 1, 0, seed=11)
    samp.set_epoch(epoch)
    ld = DeviceLoader(ds, samp, batch_size=32, device="cpu", workers=2,
                      **kw)
    return [tuple(t.numpy().tobytes() for t in b) for b in ld], ld


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_loader_epochs_equal_the_host_path(depth):
    rng = np.random.default_rng(4)
    data = rng.normal(size=(256, 3)).astype(np.float32)
    labels = np.arange(256, dtype=np.int32)
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, data, labels)
        base, _ = _epoch(ds)
        got, ld = _epoch(ds, readahead_windows=depth,
                         readahead_window_batches=2)
        assert ld.readahead_fallback_reason is None
        assert got == base
        assert ld.metrics.summary()["readahead"]["windows"] == 4
        # the ring is reused by the next epoch of the same loader
        ring = ld._ra_ring
        ld.sampler.set_epoch(4)
        assert [tuple(t.numpy().tobytes() for t in b) for b in ld] == \
            _epoch(ds, epoch=4)[0]
        assert all(a is b for v in ring for a, b in
                   zip(ring[v], ld._ra_ring[v]))
        assert s.async_pending() == 0


def test_cancellation_leaves_no_inflight_reads():
    rng = np.random.default_rng(6)
    with DDStore(backend="local") as s:
        ds = ShardedDataset(s, rng.normal(size=(512, 4)).astype(np.float32))
        samp = DistributedSampler(len(ds), 1, 0, seed=12)
        ld = DeviceLoader(ds, samp, batch_size=32, device="cpu", workers=2,
                          readahead_windows=2, readahead_window_batches=2)
        for _ in range(2):
            it = iter(ld)
            next(it)
            it.close()  # the generator's finally: ra.close(), pool join
            assert s.async_pending() == 0
        assert len(list(ld)) == 16  # and a whole epoch after that


def _fallback_loaders(s, data):
    ds = ShardedDataset(s, data)
    samp = DistributedSampler(len(ds), 1, 0)

    class OneShot:
        def __init__(self):
            self._it = iter(range(128))

        def __len__(self):
            return 128

        def __iter__(self):
            return self

        def __next__(self):
            return next(self._it)

    s.add_ragged("g", [np.zeros((2, 2), np.float32)] * 4)

    class Ragged:
        store, data_var = s, "g"

        def fetch(self, idx):
            return s.get_ragged_batch("g", idx)[0]

    return {"callable": (lambda i: data[i], samp),
            "unsized": (ds, iter(range(128))),
            "one-shot": (ds, OneShot()),
            "ragged": (Ragged(), samp)}


@pytest.mark.parametrize("case", ["callable", "unsized", "one-shot",
                                  "ragged"])
def test_fallback_reasons_match_reference(case):
    data = np.arange(256, dtype=np.float32).reshape(128, 2)
    reasons = {}
    for key, make, loader in (("ref", ref.DDStore, None),
                              ("port", DDStore, DeviceLoader)):
        with make(backend="local") as s:
            dset, samp = _fallback_loaders(s, data)[case]
            if loader is None:
                from ddstore_tpu.data import DeviceLoader as RefLoader
                ld = RefLoader(dset, samp, batch_size=16,
                               readahead_windows=2)
            else:
                ld = loader(dset, samp, batch_size=16, device="cpu",
                            readahead_windows=2)
                if case != "ragged":  # per-batch reads, still correct
                    first = next(iter(ld))
                    np.testing.assert_array_equal(first, data[:16]
                                                  if case != "callable"
                                                  else data[list(samp)[:16]])
            assert not ld._readahead_ready
            reasons[key] = ld.readahead_fallback_reason
            assert s.async_pending() == 0
    assert reasons["port"] == reasons["ref"]


def test_readahead_warms_the_hot_cache_and_evicts_on_consumption():
    """With the store's hot-row cache armed, the engine hands each planned
    window's rows to the cache ahead of its read and evicts them once
    the window is consumed, as the reference's engine does."""
    world, rows = 2, 2048
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, world * rows, size=128) for _ in range(24)]
    full = np.concatenate([np.full((rows, 8), r + 1.0, np.float32)
                           for r in range(world)])
    name = uuid.uuid4().hex

    def body(rank):
        g = rdv.ThreadGroup(name, rank, world)
        with DDStore(g, backend="local") as s:
            s.add("v", np.full((rows, 8), rank + 1.0, np.float32))
            s.tier_configure(64 << 20)
            s.barrier()
            stats = None
            if rank == 0:
                with tra.EpochReadahead(s, "v", list(batches),
                                        window_batches=4, depth=2) as ra:
                    for i, b in enumerate(batches):
                        np.testing.assert_array_equal(ra.get_batch(i, b),
                                                      full[b])
                stats = dict(s.tiering_stats(), pending=s.async_pending())
            s.barrier()
            return stats

    stats = run_threads(world, body)[0]
    assert stats["cache_fills"] >= 4 and stats["cache_hits"] > 0, stats
    assert stats["cache_entries"] == 0 and stats["cache_bytes"] == 0, stats
    assert stats["pending"] == 0
