"""The port's global shuffle and row exchanges (``parallel/shuffle.py``)
against the JAX package's.

* ``all_to_all_rows``, ``exchange_rows`` and ``permute_rows`` over 4
  spawned gloo ranks concatenate bit for bit to the reference's on a
  ``dp=4`` mesh.
* ``host_global_shuffle`` and ``ragged_global_shuffle`` over 2 spawned
  ranks on TCP stores leave the same shards as the reference's on a
  ``ThreadGroup`` store with the same data and seed (and the fixed-width
  one is the plain permutation by ``seeded_perm_slice``); shuffling half
  of a ragged pair is refused with the reference's messages.
* ``global_shuffle_epoch`` draws its permutations from
  ``torch.Generator``s, not ``jax.random``, so it cannot match the
  reference bit for bit: its tests are structural (a permutation, mixing
  across shards, deterministic for a seed, different across seeds)."""

import uuid

import numpy as np
import pytest

import ddstore_tpu as ref
import jax
from ddstore_tpu.data import device_fetch as rdf
from ddstore_tpu.data.dataset import nsplit
from ddstore_tpu.data.permute import seeded_perm_slice
from ddstore_tpu.parallel import make_mesh
from ddstore_tpu.parallel import shuffle as rsh
from torch_workers import device_shuffles, host_shuffles, run_threads, spawn

pytestmark = pytest.mark.tier1_required

WORLD, N = 4, 32  # rows per rank


@pytest.fixture(scope="module")
def device_world(tmp_path_factory):
    rng = np.random.default_rng(3)
    x = np.arange(WORLD * N * 3, dtype=np.float32).reshape(WORLD * N, 3)
    plan = rdf.plan_device_fetch(np.array([0, 20, 64, 100, 128]),
                                 rng.integers(0, 128, size=WORLD * 8), WORLD)
    staged = np.zeros((plan.staged_rows, 2), np.int32)
    staged[plan.staged_pos] = rng.integers(0, 1 << 30, size=(WORLD * 8, 2))
    perm = rng.permutation(WORLD * N)
    got = spawn(WORLD, device_shuffles, str(tmp_path_factory.mktemp("dev")),
                x, staged, plan.inv, perm)
    return x, plan, staged, perm, got


def _sharded(a, mesh):
    return jax.device_put(a, jax.NamedSharding(mesh, jax.P("dp")))


def test_all_to_all_rows_matches_reference(device_world):
    x, _plan, _staged, _perm, got = device_world
    mesh = make_mesh({"dp": WORLD})
    want = np.asarray(rsh.all_to_all_rows(_sharded(x, mesh), mesh))
    assert np.concatenate([g["a2a"] for g in got]).tobytes() == \
        want.tobytes()


def test_exchange_rows_matches_reference(device_world):
    _x, plan, staged, _perm, got = device_world
    mesh = make_mesh({"dp": WORLD})
    want = np.asarray(rsh.exchange_rows(_sharded(staged, mesh),
                                        _sharded(plan.inv, mesh), mesh=mesh))
    assert np.concatenate([g["exchange"] for g in got]).tobytes() == \
        want.tobytes()


def test_permute_rows_matches_reference(device_world):
    x, _plan, _staged, perm, got = device_world
    mesh = make_mesh({"dp": WORLD})
    want = np.asarray(rsh.permute_rows(_sharded(x, mesh), perm, mesh))
    assert np.concatenate([g["permute"] for g in got]).tobytes() == \
        want.tobytes()
    np.testing.assert_array_equal(want, x[perm])


def test_global_shuffle_epoch_is_a_mixing_permutation(device_world):
    x, _plan, _staged, _perm, got = device_world
    first = np.concatenate([g["epoch"][0] for g in got])
    # a permutation of the rows
    assert sorted(first[:, 0].tolist()) == sorted(x[:, 0].tolist())
    # every rank's shard holds rows of every source shard
    src = (first[:, 0] // 3).astype(int) // N
    for r in range(WORLD):
        assert set(src[r * N:(r + 1) * N].tolist()) == set(range(WORLD))
    # deterministic for a seed, different across seeds
    again = np.concatenate([g["epoch"][1] for g in got])
    other = np.concatenate([g["epoch"][2] for g in got])
    np.testing.assert_array_equal(first, again)
    assert not np.array_equal(first, other)


def _reference_host_shuffles(data, samples, seed, world):
    name = uuid.uuid4().hex

    def body(rank):
        with ref.DDStore(ref.ThreadGroup(name, rank, world),
                         backend="local") as s:
            counts = nsplit(len(data), world)
            lo = sum(counts[:rank])
            s.add("v", data[lo:lo + counts[rank]])
            counts = nsplit(len(samples), world)
            lo = sum(counts[:rank])
            s.add_ragged("g", samples[lo:lo + counts[rank]])
            errors = []
            for v in ("g/index", "g/values", "g"):
                try:
                    rsh.host_global_shuffle(s, v, seed)
                except ValueError as e:
                    errors.append(str(e))
            rsh.host_global_shuffle(s, "v", seed)
            rsh.ragged_global_shuffle(s, "g", seed)
            b, e = s.my_row_range("v")
            fixed = s.get_batch("v", np.arange(b, e))
            b, e = s.my_row_range("g/index")
            values, lens = s.get_ragged_batch("g", np.arange(b, e))
            s.barrier()
            return fixed, values, lens, errors

    return run_threads(world, body)


@pytest.fixture(scope="module")
def host_world(tmp_path_factory):
    rng = np.random.default_rng(8)
    data = rng.normal(size=(37, 5))
    data[:, 0] = np.arange(37)
    samples = [np.full((i % 4 + 1, 2), i, np.int32) for i in range(23)]
    got = spawn(2, host_shuffles, str(tmp_path_factory.mktemp("host")),
                data, samples, 99)
    want = _reference_host_shuffles(data, samples, 99, 2)
    return data, samples, got, want


def test_host_global_shuffle_matches_reference(host_world):
    data, _samples, got, want = host_world
    for g, w in zip(got, want):
        assert g[0].tobytes() == w[0].tobytes()
    shards = np.concatenate([g[0] for g in got])
    perm = seeded_perm_slice(len(data), 0, len(data), 99)
    np.testing.assert_array_equal(shards, data[perm])


def test_ragged_global_shuffle_matches_reference(host_world):
    _data, samples, got, want = host_world
    for g, w in zip(got, want):
        assert g[1].tobytes() == w[1].tobytes()
        np.testing.assert_array_equal(g[2], w[2])
    # a permutation of the samples, each moved whole
    lens = np.concatenate([g[2] for g in got])
    assert sorted(lens.tolist()) == sorted(len(s) for s in samples)


def test_shuffling_half_a_ragged_pair_is_refused(host_world):
    _data, _samples, got, want = host_world
    for g, w in zip(got, want):
        assert len(g[3]) == 3 and g[3] == w[3]
