"""Parity of the port's host layer (store, permutation, sampler, loader)
with the JAX package's, which it copies: the same bytes for the same
reads, the same index order for the same sampler arguments, and the same
batches epoch for epoch. Exact equality throughout."""

import numpy as np
import pytest
import torch

import ddstore_tpu as ref
from ddstore_tpu.data import dataset as rds
from ddstore_tpu.data import loader as rld
from ddstore_tpu.data import permute as rperm
from ddstore_tpu_torch import store as tstore
from ddstore_tpu_torch.data import dataset as tds
from ddstore_tpu_torch.data import loader as tld
from ddstore_tpu_torch.data import permute as tperm

pytestmark = pytest.mark.tier1_required


def _stores():
    return (ref.DDStore(ref.SingleGroup(), backend="local"),
            tstore.DDStore())


def _rows(n=97, seed=0):
    rng = np.random.default_rng(seed)
    return {"f32": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "tok": rng.integers(0, 1 << 30, (n, 16), dtype=np.int32),
            "u8": rng.integers(0, 255, (n, 28, 28), dtype=np.uint8)}


def test_store_reads_are_byte_identical():
    rs, ts = _stores()
    rows = _rows()
    for name, arr in rows.items():
        rs.add(name, arr)
        ts.add(name, arr)
    idx = np.random.default_rng(1).integers(0, 97, 300)
    idx[:5] = [96, 0, 0, 96, 3]  # unsorted, duplicated, both ends
    for name, arr in rows.items():
        want = rs.get_batch(name, idx)
        got = ts.get_batch(name, idx)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        out = np.empty_like(want)
        assert ts.get_batch(name, idx, out=out) is out
        assert out.tobytes() == want.tobytes()
        assert ts.get(name, 10, 7).tobytes() == rs.get(name, 10, 7).tobytes()
        np.testing.assert_array_equal(ts.row_starts(name),
                                      rs.row_starts(name))
        np.testing.assert_array_equal(ts.owner_of_rows(name, idx),
                                      rs.owner_of_rows(name, idx))
        assert ts.total_rows(name) == rs.total_rows(name) == 97
        assert ts.local_rows(name) == rs.local_rows(name)
        assert ts.my_row_range(name) == rs.my_row_range(name)
        assert ts.row_nbytes(name) == rs.row_nbytes(name)
    assert (ts.rank, ts.world) == (rs.rank, rs.world) == (0, 1)
    rs.close()
    ts.close()


def test_store_refusals_match_reference_codes():
    rs, ts = _stores()
    arr = np.arange(20, dtype=np.int64).reshape(10, 2)
    rs.add("x", arr)
    ts.add("x", arr)
    for bad in (lambda s: s.get("x", 9, 2), lambda s: s.get("x", -1),
                lambda s: s.get("x", 10, 0), lambda s: s.get("x", 0, 11),
                lambda s: s.get_batch("x", [3, 10]),
                lambda s: s.get_batch("x", [-1]),
                lambda s: s.add("x", arr)):
        with pytest.raises(ref.DDStoreError) as rerr:
            bad(rs)
        with pytest.raises(tstore.DDStoreError) as terr:
            bad(ts)
        assert terr.value.code == rerr.value.code
    with pytest.raises(ValueError):
        ts.get_batch("x", [1], out=np.empty((1, 2), np.int32))
    with pytest.raises(KeyError):
        ts.get("nope", 0)
    rs.close()
    ts.close()


def test_store_free_and_context_manager():
    with tstore.DDStore() as ts:
        ts.add("a", np.zeros((4, 2), np.float32))
        ts.add("b", np.ones((3,), np.float32))
        ts.free("a")
        assert ts.variables() == ["b"]
        with pytest.raises(KeyError):
            ts.get("a", 0)
    assert ts.variables() == []


def test_store_owns_a_copy_of_each_shard():
    arr = np.arange(6, dtype=np.float32).reshape(3, 2)
    ts = tstore.DDStore()
    ts.add("x", arr)
    arr[0] = -1
    assert ts.get("x", 0)[0, 0] == 0


def test_multi_process_group_is_refused():
    class Two(tstore.ProcessGroup):
        rank, size = 0, 2

    with pytest.raises(NotImplementedError):
        tstore.DDStore(Two())


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 3), (1000, (5, 2)),
                                    (1 << 17, 11)])
def test_feistel_permutation_matches_reference(n, seed):
    idx = np.arange(min(n, 4096))
    want = rperm.FeistelPermutation(n, seed)(idx)
    got = tperm.FeistelPermutation(n, seed)(idx)
    np.testing.assert_array_equal(got, want)
    assert tperm.DENSE_MAX == rperm.DENSE_MAX
    assert tperm.FeistelPermutation(n, seed)(0) == \
        rperm.FeistelPermutation(n, seed)(0)


@pytest.mark.parametrize("mode", ["dense", "streamed"])
@pytest.mark.parametrize("total,world,drop_last,shuffle",
                         [(103, 4, False, True), (103, 4, True, True),
                          (64, 1, False, True), (10, 3, False, False)])
def test_sampler_order_matches_reference(mode, total, world, drop_last,
                                         shuffle):
    for rank in range(world):
        kw = dict(total=total, world=world, rank=rank, shuffle=shuffle,
                  seed=7, drop_last=drop_last, mode=mode, block=16)
        rs, ts = rds.DistributedSampler(**kw), tds.DistributedSampler(**kw)
        assert len(ts) == len(rs)
        for epoch in range(3):
            rs.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(rs)
            np.testing.assert_array_equal(ts.epoch_indices(),
                                          rs.epoch_indices())
            for tb, rb in zip(ts.batches(5), rs.batches(5), strict=True):
                np.testing.assert_array_equal(tb, rb)


def test_nsplit_matches_reference():
    for n, parts in [(10, 3), (0, 2), (7, 7), (5, 8)]:
        assert tds.nsplit(n, parts) == rds.nsplit(n, parts)


def _datasets(n=50, seq=16):
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (n, seq), dtype=np.int32)
    labels = rng.integers(0, 256, (n, seq), dtype=np.int32)
    rs, ts = _stores()
    return (rs, rds.ShardedDataset(rs, data, labels, name="lm")), \
        (ts, tds.ShardedDataset(ts, data, labels, name="lm"))


def test_dataset_fetch_matches_reference():
    (rs, rd), (ts, td) = _datasets()
    assert len(td) == len(rd) == 50
    assert td.specs() == [((16,), np.dtype(np.int32))] * 2
    idx = [49, 3, 3, 0, 17]
    for got, want in zip(td.fetch(idx), rd.fetch(idx), strict=True):
        assert got.tobytes() == want.tobytes()
    for got, want in zip(td[12], rd[12], strict=True):
        np.testing.assert_array_equal(got, want)
    rs.close()
    ts.close()


@pytest.mark.parametrize("drop_last,workers,batch",
                         [(True, None, 8), (False, 3, 7), (True, 1, 50)])
def test_loader_epoch_matches_reference(drop_last, workers, batch):
    (rs, rd), (ts, td) = _datasets()
    mk = dict(total=50, world=1, rank=0, seed=3)
    rl = rld.DeviceLoader(rd, rds.DistributedSampler(**mk), batch,
                          mesh=None, drop_last=drop_last, workers=workers)
    tl = tld.DeviceLoader(td, tds.DistributedSampler(**mk), batch,
                          device="cpu", drop_last=drop_last,
                          workers=workers)
    assert len(tl) == len(rl)
    for epoch in range(2):
        rl.sampler.set_epoch(epoch)
        tl.sampler.set_epoch(epoch)
        want = list(rl)
        got = list(tl)
        assert len(got) == len(want) == len(tl)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
            np.testing.assert_array_equal(gx.numpy(), wx)
            np.testing.assert_array_equal(gy.numpy(), wy)
    m = tl.metrics.summary()
    assert m["host_fetch"]["count"] == 2 * len(tl)
    assert m["device_put"]["count"] == 2 * len(tl)
    assert m["device_wait"]["count"] == 2 * len(tl)
    assert 0.0 <= m["input_pipeline_efficiency"] <= 1.0
    rs.close()
    ts.close()


def test_loader_transform_and_callable_dataset():
    def fetch(idx):
        return np.stack([np.full(3, i, np.int64) for i in idx])

    tl = tld.DeviceLoader(fetch, tds.DistributedSampler(10, 1, 0,
                                                        shuffle=False),
                          4, device="cpu", drop_last=False,
                          transform=lambda b: b * 2)
    got = [b.numpy() for b in tl]
    assert [len(b) for b in got] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate(got)[:, 0],
                                  np.arange(10) * 2)


@pytest.mark.parametrize("kw", [dict(readahead_windows=2),
                                dict(device_collective=True)])
def test_loader_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        tld.DeviceLoader(lambda i: i, range(4), 2, device="cpu", **kw)


def test_loader_defaults_to_the_card(monkeypatch):
    # With no card the default device is refused, never replaced by the
    # CPU; the CPU path needs device="cpu".
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tld.DeviceLoader(lambda i: i, range(4), 2)
