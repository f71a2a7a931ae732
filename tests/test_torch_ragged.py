"""The port's ragged variables (``DDStore.add_ragged`` and its readers)
and its copy of ``data/ragged.py`` against the JAX package's: the same
shards give the same ``get_ragged``/``get_ragged_batch`` bytes and
lengths over the in-process and the TCP transport, rank stamps pin which
owner served each sample, a rank with no samples adopts the group's
dtype and item shape, and the four helpers return what the reference's
return on the same inputs. Exact equality throughout."""

import numpy as np
import pytest

import ddstore_tpu as ref
from ddstore_tpu.data import ragged as rrag
from ddstore_tpu_torch import rendezvous as rdv
from ddstore_tpu_torch import store as tstore
from ddstore_tpu_torch.binding import ERR_PEER_LOST
from ddstore_tpu_torch.data import ragged as trag
from torch_workers import run_threads

pytestmark = pytest.mark.tier1_required


def _samples(rank, n, dim=3, seed=0, stamp=True):
    """Ragged samples of 0-6 elements; with ``stamp`` every value is the
    owning rank + 1."""
    rng = np.random.default_rng((seed, rank))
    lens = rng.integers(0, 7, size=n)
    if stamp:
        return [np.full((int(l), dim), rank + 1, np.float32) for l in lens]
    return [rng.normal(size=(int(l), dim)).astype(np.float32)
            for l in lens]


def test_single_rank_add_get_batch():
    samples = [np.arange(6, dtype=np.float32).reshape(3, 2),
               np.zeros((0, 2), np.float32),
               np.ones((5, 2), np.float32) * 7]
    with tstore.DDStore(backend="local") as s:
        s.add_ragged("g", samples)
        assert s.is_ragged("g") and not s.is_ragged("nope")
        assert s.ragged_total("g") == 3
        for i, want in enumerate(samples):
            got = s.get_ragged("g", i)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        vals, lens = s.get_ragged_batch("g", [2, 0, 1, 2])
        assert lens.tolist() == [5, 3, 0, 5] and lens.dtype == np.int64
        np.testing.assert_array_equal(
            vals, np.concatenate([samples[2], samples[0], samples[2]]))
        vals, lens = s.get_ragged_batch("g", [])
        assert vals.shape == (0, 2) and lens.shape == (0,)
        with pytest.raises(tstore.DDStoreError):
            s.add_ragged("g", samples)  # already exists
        with pytest.raises(ValueError, match="inconsistent"):
            s.add_ragged("h", [np.zeros((2, 2), np.float32),
                               np.zeros((2, 3), np.float32)])
        # the two halves are plain variables of the store
        assert {"g/values", "g/index"} <= set(s.variables())


def test_peer_lost_in_index_add_unwinds_values(monkeypatch):
    # a member lost while the index half registers: the values half is
    # freed, so no partial ragged variable lingers
    with tstore.DDStore(backend="local") as s:
        add = s.add

        def failing_add(name, *a, **k):
            if name.endswith("/index"):
                raise tstore.DDStoreError(ERR_PEER_LOST, "add")
            return add(name, *a, **k)

        monkeypatch.setattr(s, "add", failing_add)
        with pytest.raises(tstore.DDStoreError) as e:
            s.add_ragged("g", [np.ones((2, 2), np.float32)])
        assert e.value.code == ERR_PEER_LOST
        assert not s.is_ragged("g") and s.variables() == []
        monkeypatch.setattr(s, "add", add)
        s.add_ragged("g", [np.ones((2, 2), np.float32)])  # name is free
        assert s.get_ragged("g", 0).tolist() == [[1, 1], [1, 1]]


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_four_thread_ranks_rank_stamp(backend):
    world, n = 4, 12

    def fn(rank):
        g = rdv.ThreadGroup(f"rag4-{backend}", rank, world)
        with tstore.DDStore(g, backend=backend) as s:
            s.add_ragged("g", _samples(rank, n))
            assert s.ragged_total("g") == world * n
            idx = np.random.default_rng(100 + rank).integers(
                0, world * n, size=32)
            vals, lens = s.get_ragged_batch("g", idx)
            pos = 0
            for i, l in zip(idx, lens):
                got = vals[pos:pos + int(l)]
                assert (got == int(i) // n + 1).all(), (i, got)
                np.testing.assert_array_equal(s.get_ragged("g", int(i)),
                                              got)
                pos += int(l)
            s.barrier()
            return int(lens.sum())

    assert all(t > 0 for t in run_threads(world, fn))


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_rank_with_no_samples(backend):
    def fn(rank):
        g = rdv.ThreadGroup(f"ragempty-{backend}", rank, 2)
        with tstore.DDStore(g, backend=backend) as s:
            mine = ([np.full((4, 2, 3), 1, np.int16),
                     np.full((1, 2, 3), 2, np.int16)] if rank == 1 else [])
            s.add_ragged("g", mine)
            assert s.ragged_total("g") == 2
            assert s.local_rows("g/index") == len(mine)
            got = s.get_ragged("g", 1)
            vals, lens = s.get_ragged_batch("g", [1, 0])
            s.barrier()
            # the empty rank adopted the group's dtype and item shape
            return (s.query("g/values")["dtype"], got.tolist(),
                    vals.shape, lens.tolist())

    for dtype, got, shape, lens in run_threads(2, fn):
        assert dtype == np.int16
        assert got == np.full((1, 2, 3), 2).tolist()
        assert shape == (5, 2, 3) and lens == [1, 4]


@pytest.mark.parametrize("backend", ["local", "tcp"])
def test_ragged_batch_matches_reference_store(backend):
    world, n = 3, 10
    res = {}
    for key, mod, make in (("ref", ref, ref.DDStore),
                           ("port", rdv, tstore.DDStore)):
        def fn(r, mod=mod, make=make, key=key):
            g = mod.ThreadGroup(f"ragref-{backend}-{key}", r, world)
            with make(g, backend=backend) as s:
                s.add_ragged("g", _samples(r, n + r, stamp=False, seed=7))
                total = s.ragged_total("g")
                idx = np.random.default_rng(r).integers(0, total, 40)
                vals, lens = s.get_ragged_batch("g", idx)
                one = [s.get_ragged("g", int(i)).tobytes() for i in idx[:8]]
                rows = s.row_starts("g/values").tolist()
                s.barrier()
                return (total, vals.tobytes(), vals.shape, lens.tolist(),
                        one, rows, s.my_row_range("g/index"))
        res[key] = run_threads(world, fn)
    assert res["port"] == res["ref"]


_VALUES = np.random.default_rng(5).normal(size=(11, 2)).astype(np.float32)
_LENGTHS = np.array([3, 0, 2, 4, 2])
HELPERS = {
    "split_ragged": lambda m: [a.tolist()
                               for a in m.split_ragged(_VALUES, _LENGTHS)],
    "pad_ragged": lambda m: [a.tolist() for a in
                             m.pad_ragged(_VALUES, _LENGTHS, 3, -1.0)],
    "segment_ids_from_lengths": lambda m: [
        m.segment_ids_from_lengths(_LENGTHS, 14).tolist(),
        m.segment_ids_from_lengths(_LENGTHS, 11, pad_segment=9).tolist()],
    "pack_ragged": lambda m: [
        [a.tolist() if hasattr(a, "tolist") else a
         for a in m.pack_ragged(_VALUES, _LENGTHS, budget)]
        for budget in (4, 9, 11, 20)],
}


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_helpers_match_reference(helper):
    assert HELPERS[helper](trag) == HELPERS[helper](rrag)
    # the reference's refusals, too
    with pytest.raises(ValueError):
        trag.segment_ids_from_lengths(_LENGTHS, 5)
    with pytest.raises(ValueError):
        trag.pack_ragged(_VALUES, _LENGTHS, budget=2)
