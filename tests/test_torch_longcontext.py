"""Parity of the port's long-context slice with the JAX reference, on the
CPU: the dp x sp train step, remat, the ring prefill of ``generate`` and
the loader's ``spec=("dp", "sp")`` placement.

The JAX side runs in this process on ``make_mesh({"dp": 2, "sp": 2})``
over 4 of the 8 virtual CPU devices of ``tests/conftest.py``; the port
runs in one spawned gloo world of 4 ranks on the same mesh
(``torch_workers.longcontext_cases``), each rank holding its (B/2, S/2)
part of every batch.

Tolerances: losses 1e-5 relative (f32; the frameworks sum in different
orders); gradients rtol 1e-4, atol 1e-6, as ``tests/test_torch_train.py``
holds them (summation order only); the update of each parameter over two
Adam steps (parameters after less parameters before) within 1e-2 of the
learning rate of JAX's update. Not 1e-5 of each parameter: Adam divides
by sqrt(nu), so a gradient near its eps (1e-8; some here are 4e-8) turns
the frameworks' f32 summation noise into update differences of a few
thousandths of the learning rate (2.7e-3 at most here), and parameters
near 0 then differ by far more than 1e-5 of themselves. Remat against
no remat in the port: bit for bit. Tokens of ``generate`` and the
loader's chunks: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu.data import DeviceLoader as JLoader
from ddstore_tpu.data import ShardedDataset as JDataset
from ddstore_tpu.models import decode as jdec
from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.parallel import make_mesh as j_make_mesh
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import transformer as ttr

from torch_parity import SMALL, flat_leaves, lm_pair, positions, tokens
from torch_workers import longcontext_cases, spawn

pytestmark = pytest.mark.tier1_required

WORLD, LR = 4, 1e-2
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
UPDATE_TOL = 1e-2  # of the learning rate
REMAT = {"off": {}, "remat": {"remat": True},
         **{p: {"remat": True, "remat_policy": p}
            for p in sorted(ttr.REMAT_POLICIES)}}
PREFILL_CFG = dict(vocab=64, dim=32, heads=4, layers=2)  # test_decode._model


def _assert_trees_close(got, want, **tol):
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _assert_trees_equal(got, want):
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def _batches():
    return [(tokens(4, 64, SMALL["vocab"], seed=60 + 2 * i),
             tokens(4, 64, SMALL["vocab"], seed=61 + 2 * i), positions(4, 64))
            for i in range(2)]


def _prefill_model():
    """tests/test_decode.py:287's model: test_decode._model() with its
    final LayerNorm's scale moved off 1."""
    model = jtr.TransformerLM(compute_dtype=jnp.float32, **PREFILL_CFG)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                        jnp.tile(jnp.arange(8), (1, 1)))
    lnf = params["params"]["lmhead"]["lnf"]
    lnf["scale"] = lnf["scale"] + jax.random.uniform(
        jax.random.key(9), lnf["scale"].shape, minval=0.5, maxval=1.5)
    return model, params


def _prefill_cases():
    prompt = np.asarray(jax.random.randint(jax.random.key(3), (2, 16), 0,
                                           PREFILL_CFG["vocab"]), np.int64)
    padded = tokens(2, 32, PREFILL_CFG["vocab"], seed=5).astype(np.int64)
    return {"sp_prefill": (prompt, 5, None),
            "padded": (padded, 6, [32, 19]),
            "misaligned": (padded[:, :20], 3, None)}


def _loader_case():
    rng = np.random.default_rng(70)
    windows = rng.integers(0, 1000, (64, 32)).astype(np.int32)
    nexts = rng.integers(0, 1000, (64, 32)).astype(np.int32)
    return windows, nexts, rng.permutation(64)[:12], 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jm, params, _ = lm_pair()
    tree = jax.tree_util.tree_map(np.asarray, params)
    pm, pparams = _prefill_model()
    ranks = spawn(
        WORLD, longcontext_cases, str(tmp_path_factory.mktemp("lc")),
        {"cfg": SMALL, "tree": tree}, _batches(), LR, REMAT,
        {"cfg": PREFILL_CFG, "tree": jax.tree_util.tree_map(np.asarray,
                                                            pparams),
         "cases": _prefill_cases()}, _loader_case(), timeout=400)
    return jm, params, ranks


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh({"dp": 2, "sp": 2}, jax.devices()[:WORLD])


def _jax_grads(jm, params, batch, mesh):
    tok, tgt, pos = batch
    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(
        lambda p: jtr.lm_loss(jm, p, tok, tgt, pos, mesh=mesh)))(params))


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_sp_train_steps_match_reference(world, jmesh, accum):
    jm, params, ranks = world
    jmm = jm.clone(mesh=jmesh)
    tx = optax.adam(LR)
    jstate = jtr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jstep = jtr.make_train_step(jmm, tx, mesh=jmesh, donate=False,
                                accum_steps=accum)
    jlosses = []
    for batch in _batches():
        jstate, jl = jstep(jstate, *batch)
        jlosses.append(float(jl))
    jgrads = _jax_grads(jmm, params, _batches()[0], jmesh)
    before = flat_leaves(jax.tree_util.tree_map(np.asarray, params))
    want = flat_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    for r in ranks:
        got = r[f"train{accum}"]
        assert got["steps"] == 2
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5,
                                   atol=0)
        _assert_trees_close(got["grads"], jgrads, **GRAD_TOL)
        after = flat_leaves(got["params"])
        assert sorted(after) == sorted(want)
        for path, w in want.items():
            np.testing.assert_allclose(after[path] - before[path],
                                       w - before[path], rtol=0,
                                       atol=UPDATE_TOL * LR, err_msg=path)
    # the ranks' replicas stay equal: one all-reduce, the same update
    assert len({r[f"train{accum}"]["digest"] for r in ranks}) == 1
    assert len({tuple(r[f"train{accum}"]["losses"]) for r in ranks}) == 1


def test_train_step_rings_over_the_models_mesh(world):
    # make_train_step's mesh defaults to model.mesh: every rank reports
    # the all-reduced loss; a model with no ring is refused a mesh that
    # splits the sequence (it would attend within each chunk alone)
    _, _, ranks = world
    for r in ranks:
        assert r["default_mesh_loss"] == r["train1"]["losses"][0]
        assert "model.mesh" in r["foreign_mesh"]


@pytest.mark.parametrize("setting", sorted(REMAT))
def test_remat_changes_no_gradient_bit(world, setting):
    _, _, ranks = world
    for r in ranks:
        _assert_trees_equal(r["remat"][setting]["grads"],
                            r["remat"]["off"]["grads"])
        # a replayed block replays its forward shifts; the backward's stay
        shifts = r["remat"][setting]["shifts"]
        assert shifts["backward"] == SMALL["layers"]
        replayed = setting not in ("off", "everything_saveable")
        assert shifts["forward"] == SMALL["layers"] * (1 + replayed)


def test_remat_matches_reference(world, jmesh):
    jm, params, ranks = world
    want = _jax_grads(jm.clone(mesh=jmesh, remat=True), params,
                      _batches()[0], jmesh)
    for r in ranks:
        _assert_trees_close(r["remat"]["remat"]["mean"], want, **GRAD_TOL)


def test_remat_weights_keep_flax_names():
    # nn.remat keeps flax's block{i} names, so remat and mesh models take
    # the same trees as plain ones, and give them back unchanged
    jm, params, _ = lm_pair()
    jr = jm.clone(remat=True)
    rparams = jr.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32),
                      jnp.tile(jnp.arange(8), (1, 1)))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    tm = ttr.TransformerLM(compute_dtype=torch.float32, device="cpu",
                           remat=True, **SMALL)
    _assert_trees_equal(weights.to_flax(weights.from_flax(tree, tm)), tree)


def test_mesh_model_weights_round_trip(world):
    jm, params, ranks = world
    for r in ranks:
        _assert_trees_equal(r["round_trip"],
                            jax.tree_util.tree_map(np.asarray, params))


def test_replicas_that_differ_are_refused_until_broadcast(world):
    # create_train_state over a mesh checks the replicas' digest; rank 0's
    # broadcast_parameters carries its weights to the others
    _, _, ranks = world
    for r in ranks:  # rank r added r to its embedding; rank 0 added 0
        assert "parameters differ" in r["differ"]
        _assert_trees_equal(r["broadcast"], ranks[0]["round_trip"])


def test_ring_prefill_matches_reference(world):
    # tests/test_decode.py:287: the ring prefill gives the mesh-free
    # tokens exactly
    _, _, ranks = world
    model, params = _prefill_model()
    prompt, n, _ = _prefill_cases()["sp_prefill"]
    want = np.asarray(jdec.generate(model, params, jnp.asarray(prompt), n))
    spm = model.clone(mesh=j_make_mesh({"dp": 1, "sp": 2},
                                       jax.devices()[:2]))
    got_jax = np.asarray(jax.jit(lambda p, t: jdec.generate(
        spm, p, t, n, prefill_mesh=spm.mesh))(params, jnp.asarray(prompt)))
    np.testing.assert_array_equal(got_jax, want)
    for r in ranks:
        np.testing.assert_array_equal(r["prefill"]["sp_prefill"], want)


def test_ring_prefill_with_prompt_lengths(world):
    _, _, ranks = world
    model, params = _prefill_model()
    prompt, n, lengths = _prefill_cases()["padded"]
    want = np.asarray(jdec.generate(
        model, params, jnp.asarray(prompt), n,
        prompt_lengths=jnp.asarray(lengths, jnp.int32)))
    for r in ranks:
        np.testing.assert_array_equal(r["prefill"]["padded"], want)


def test_ring_prefill_rejects_misaligned_chunks(world):
    _, _, ranks = world
    for r in ranks:
        assert "multiples of 8" in r["prefill"]["misaligned"]


def test_loader_chunks_match_reference_placement(world, jmesh):
    # the reference's P("dp", "sp") placement of the same global batches
    _, _, ranks = world
    windows, nexts, idx, bsz = _loader_case()
    from ddstore_tpu import DDStore as JStore

    store = JStore()
    try:
        ds = JDataset(store, windows, nexts)
        jl = JLoader(ds, [int(i) for i in idx], bsz, mesh=jmesh,
                     spec=jax.sharding.PartitionSpec("dp", "sp"))
        jbatches = list(jl)
        assert len(jbatches) == 3
        where = {int(d.id): pos for pos, d in np.ndenumerate(jmesh.devices)}
        for b, (jtok, jtgt) in enumerate(jbatches):
            for arr, k in ((jtok, 0), (jtgt, 1)):
                for sh in arr.addressable_shards:
                    i, j = where[int(sh.device.id)]
                    r = ranks[i * 2 + j]
                    assert (r["dp"], r["sp"]) == (i, j)
                    np.testing.assert_array_equal(
                        r["loader"]["batches"][b][k], np.asarray(sh.data))
        for rank, r in enumerate(ranks):
            lo, hi = r["loader"]["seq_range"]
            assert (lo, hi) == (16 * r["sp"], 16 * (r["sp"] + 1))
            np.testing.assert_array_equal(
                r["loader"]["positions"],
                np.tile(np.arange(lo, hi, dtype=np.int32), (2, 1)))
    finally:
        store.close()


@pytest.mark.parametrize("spec", [("sp", "sp")])
def test_loader_refuses_other_specs(world, spec):
    # a spec that names one mesh axis twice, which NamedSharding refuses
    # too (a batch on a model or sequence axis is placed: below)
    _, _, ranks = world
    for r in ranks:
        assert "twice" in r["loader"][spec]


@pytest.mark.parametrize("spec", [("dp",), ("dp", "tp"), ("tp",),
                                  (("dp", "tp"),)])
def test_loader_places_over_a_tp_mesh(world, spec):
    # the reference's P("dp"), P("dp", "tp"), P("tp") and P(("dp", "tp"))
    # of the same global batches on a dp x tp mesh: each rank reads the
    # rows of its slot along the spec's batch axes (batch_slot: dp, tp, or
    # dp x tp with dp the slowest), whole or in its chunk along tp, and
    # the ranks along the other axis the same rows
    _, _, ranks = world
    windows, nexts, idx, bsz = _loader_case()
    from ddstore_tpu import DDStore as JStore

    tmesh = j_make_mesh({"dp": 2, "tp": 2}, jax.devices()[:WORLD])
    store = JStore()
    try:
        ds = JDataset(store, windows, nexts)
        jl = JLoader(ds, [int(i) for i in idx], bsz, mesh=tmesh,
                     spec=jax.sharding.PartitionSpec(*spec))
        where = {int(d.id): pos for pos, d in np.ndenumerate(tmesh.devices)}
        for b, (jtok, jtgt) in enumerate(jl):
            for arr, k in ((jtok, 0), (jtgt, 1)):
                for sh in arr.addressable_shards:
                    i, j = where[int(sh.device.id)]
                    r = ranks[i * 2 + j]["loader"][spec]
                    assert r["tp"] == j
                    np.testing.assert_array_equal(r["batches"][b][k],
                                                  np.asarray(sh.data))
    finally:
        store.close()
    for r in ranks:
        got = r["loader"][spec]
        i, j = got["dp"], got["tp"]
        assert got["slot"] == {("dp",): (i, 2), ("dp", "tp"): (i, 2),
                               ("tp",): (j, 2),
                               (("dp", "tp"),): (2 * i + j, 4)}[spec]
        assert got["seq_range"] == ((16 * j, 16 * (j + 1))
                                    if spec == ("dp", "tp") else None)
