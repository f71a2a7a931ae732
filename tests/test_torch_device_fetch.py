"""The port's device-collective fetch (``data/device_fetch.py`` and the
loader's ``device_collective``) against the JAX package's and against
the host path.

* Every ``DeviceFetchPlan`` field equals the reference's on seeded
  uneven owner tables (the cases of ``tests/test_device_fetch.py::
  TestPlanner``), with the same errors for bad geometry and a tight
  ``cap``; each rank's ledger share sums to the reference's
  ``bytes_ledger``.
* ``exchange_staged`` over 4 spawned gloo ranks, fed the reference's
  staged buffer and ``inv``, concatenates bit for bit to the reference's
  ``exchange_rows`` on a ``dp=4`` mesh.
* ``device_fetch_batch``/``device_fetch_ragged_batch`` over 2 and 4
  ranks (TCP stores, rank-stamped rows, duplicates): every rank's bytes
  equal the host reads of its slice.
* The loader's collective epochs (plain and through readahead) are byte
  identical to the host reads of each rank's slices; one rank's staging
  failing once sends every rank through the host path for that batch,
  with no hang (the spawn has a time limit); the fallback reasons.

Exact equality throughout."""

import numpy as np
import pytest

import jax
from ddstore_tpu.data import device_fetch as rdf
from ddstore_tpu.parallel import make_mesh
from ddstore_tpu.parallel.shuffle import exchange_rows as ref_exchange_rows
from ddstore_tpu_torch.data import device_fetch as tdf
from torch_workers import collective_fetch, collective_loader, \
    exchange_parity, spawn

pytestmark = pytest.mark.tier1_required

STARTS = np.array([0, 10, 30, 33, 64], np.int64)  # 4 uneven owners
PLAN_CASES = {
    "uniform": (STARTS, np.random.default_rng(0).integers(0, 64, 32), 8,
                None),
    "send counts": (STARTS, np.random.default_rng(1).integers(0, 64, 64),
                    8, None),
    "worst skew": (STARTS, np.full(32, 15, np.int64), 8, None),
    "duplicates": (STARTS, np.random.default_rng(2).integers(0, 64, 48), 8,
                   None),
    "ordered": (STARTS, np.arange(32), 8, None),
    "one shard per owner": (STARTS, np.random.default_rng(3).integers(
        0, 64, 40), 4, None),
    "explicit cap": (STARTS, np.full(32, 15, np.int64), 8, 4),
}
FIELDS = ("idx", "dest", "owner", "src", "slot", "staged_pos", "inv",
          "send_counts")


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_matches_reference(case):
    starts, idx, d, cap = PLAN_CASES[case]
    got = tdf.plan_device_fetch(starts, idx, d, cap=cap)
    want = rdf.plan_device_fetch(starts, idx, d, cap=cap)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_shards", "n_owners", "per_shard", "shards_per_owner",
              "cap", "staged_rows"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.owner_positions) == len(want.owner_positions)
    for a, b in zip(got.owner_positions, want.owner_positions):
        np.testing.assert_array_equal(a, b)
    for rank in (None, 0, 2):
        assert got.bytes_ledger(12, rank) == want.bytes_ledger(12, rank)


@pytest.mark.parametrize("case", ["one shard per owner", "duplicates"])
def test_rank_ledgers_sum_to_reference(case):
    starts, idx, _d, _cap = PLAN_CASES[case]
    d = len(starts) - 1  # one shard per owner: the per-rank deployment
    got = tdf.plan_device_fetch(starts, idx[:d * (len(idx) // d)], d)
    want = rdf.plan_device_fetch(starts, idx[:d * (len(idx) // d)], d)
    total = {}
    for r in range(d):
        for k, v in got.rank_ledger(20, r).items():
            total[k] = total.get(k, 0) + v
    assert total == want.bytes_ledger(20)


BAD = [
    (STARTS, np.arange(30), 8, None),                      # 30 % 8
    (np.array([0, 10, 30, 64]), np.arange(8), 8, None),    # 3 owners, 8
    (STARTS, np.empty(0, np.int64), 8, None),              # empty
    (STARTS, np.full(4, 64, np.int64), 4, None),           # out of range
    (STARTS, np.full(32, 15, np.int64), 8, 1),             # tight cap
    (STARTS, np.arange(32), 8, 0),                         # cap <= 0
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_plan_errors_match_reference(case):
    starts, idx, d, cap = BAD[case]
    with pytest.raises((ValueError, IndexError)) as want:
        rdf.plan_device_fetch(starts, idx, d, cap=cap)
    with pytest.raises(want.type) as got:
        tdf.plan_device_fetch(starts, idx, d, cap=cap)
    assert str(got.value) == str(want.value)


def test_exchange_matches_reference_exchange_rows(tmp_path):
    """The reference's staged buffer and inv, exchanged by 4 gloo ranks,
    against the reference's exchange_rows on a dp=4 mesh."""
    rng = np.random.default_rng(11)
    starts = np.array([0, 16, 40, 41, 64], np.int64)
    idx = rng.integers(0, 64, size=32)
    plan = rdf.plan_device_fetch(starts, idx, 4)
    staged = np.zeros((plan.staged_rows, 3, 2), np.float32)
    staged[plan.staged_pos] = rng.normal(size=(32, 3, 2)).astype(np.float32)
    mesh = make_mesh({"dp": 4})
    sharding = jax.NamedSharding(mesh, jax.P("dp"))
    want = np.asarray(ref_exchange_rows(
        jax.device_put(staged, sharding),
        jax.device_put(plan.inv, sharding), mesh=mesh))
    got = spawn(4, exchange_parity, str(tmp_path), staged, plan.inv,
                plan.cap)
    assert np.concatenate(got).tobytes() == want.tobytes()


def _fetch_batches(world, num, seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, world * num, size=world * 6) for _ in range(3)]
    out[0][:4] = out[0][0]  # duplicates inside one destination
    out.append(np.full(world * 4, world * num - 1))  # one owner only
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def fetched(request, tmp_path_factory):
    world, num = request.param, 24
    batches = _fetch_batches(world, num, world)
    ragged = [np.random.default_rng(world + 1).integers(
        0, world * num, size=world * 5)]
    res = spawn(world, collective_fetch,
                str(tmp_path_factory.mktemp(f"fetch{world}")), num, batches,
                ragged)
    return world, num, batches, res


def test_device_fetch_batch_bytes_equal_host(fetched):
    world, _num, batches, res = fetched
    for r in res:
        assert r["fixed"] == [True] * (2 * len(batches))


def test_device_fetch_ragged_batch_equals_host(fetched):
    for r in fetched[3]:
        assert r["ragged"] == [True]


def test_per_rank_ledgers_sum_to_reference(fetched):
    world, num, batches, res = fetched
    starts = np.arange(world + 1, dtype=np.int64) * num
    for b, idx in enumerate(batches):
        want = rdf.plan_device_fetch(starts, idx, world)
        for name, row_bytes in (("v", 6 * 4), ("u8", 5)):
            total = {}
            for r in res:
                got_name, led = r["ledgers"][2 * b + ("v", "u8").index(name)]
                assert got_name == name
                assert led["bytes_over_dcn"] == 0
                for k, v in led.items():
                    total[k] = total.get(k, 0) + v
            assert total == want.bytes_ledger(row_bytes), (b, name)


@pytest.fixture(scope="module")
def loader_world(tmp_path_factory):
    return spawn(2, collective_loader, str(tmp_path_factory.mktemp("ld")),
                 48, 16, timeout=180)


def test_loader_collective_epoch_equals_host_path(loader_world):
    for r in loader_world:
        ready, reason, same, moved, coll, faults, n = r["plain"]
        assert ready and reason is None
        assert same, "collective epochs differ from the host path"
        assert moved["bytes_over_dcn"] == 0
        assert moved["bytes_local_get"] > 0 and moved["bytes_over_ici"] > 0
        assert coll == {"exchange_device": "cpu", "exchanges": n}
        assert faults["collective_batch_fallbacks"] == 0
    # the ranks' local reads cover the epoch's bytes (data + labels), once
    per_row = 4 * 4 + 8
    assert sum(r["plain"][3]["bytes_local_get"] for r in loader_world) == \
        loader_world[0]["plain"][6] * 16 * per_row


def test_collective_composition(loader_world):
    for r in loader_world:
        ready, reason, same, moved, coll, windows, pending = r["readahead"]
        assert ready and reason is None
        assert same, "readahead collective epochs differ from host path"
        assert moved["bytes_over_ici"] > 0 and moved["bytes_over_dcn"] == 0
        assert windows == 3 and pending == 0


def test_staging_failure_on_one_rank_falls_back_on_all(loader_world):
    for r in loader_world:
        same, fallbacks, exchanges, n, reason = r["failure"]
        assert same, "a batch differs after the one-rank staging failure"
        assert fallbacks == 1 and exchanges == n - 1
        assert reason.startswith("degraded mid-epoch")
    assert "injected staging fault" in loader_world[1]["failure"][4]
    assert "another rank" in loader_world[0]["failure"][4]


def test_fallback_reasons(loader_world):
    for r in loader_world:
        reasons = r["reasons"]
        assert not any(ready for ready, _ in reasons.values())
        assert "transform" in reasons["transform"][1]
        assert "divisible" in reasons["divisible"][1]
        assert "store/data_var" in reasons["callable"][1]
        assert r["fallback_slice"]
    assert "store's world" in loader_world[0]["reasons"]["group"][1]
