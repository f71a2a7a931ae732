"""Parity of the port's GNN slice with the JAX package's, on the CPU:
the graph data (``data/graphs.py``, the QM9 readers of
``data/formats.py``), the store-backed ``GraphShardedDataset``, and the
MPNN (``models/gnn.py``) from the same weights (``weights.from_flax``)
on the same packed batches.

Tolerances: graph data, datasets and readers exactly. The MPNN over
D = 8 slots against flax's ``vmap``: at f32 predictions to rtol 1e-5,
atol 1e-6, the loss to rtol 1e-5, each gradient leaf to 1e-4 of that
leaf's largest magnitude and the parameters after one Adam step to
atol 1e-5; at bf16 predictions to atol 2e-2, the loss to rtol 2e-2,
each gradient leaf to 5e-2 of its largest magnitude and the parameters
after the step to atol 5e-3 (the reference's own tolerance for a bf16
step whose summation order differs, at the same Adam lr 1e-3,
``tests/test_gnn.py``). The
two-rank DDP step (gloo, spawned processes, a different number of real
graphs on each rank) against the JAX step on the concatenated batch at
the f32 tolerances."""

import functools
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu import DDStore as RefStore
from ddstore_tpu import ThreadGroup as RefThreadGroup
from ddstore_tpu.data import formats as rfmt
from ddstore_tpu.data import graphs as rgr
from ddstore_tpu.models import gnn as jgnn
from ddstore_tpu_torch import rendezvous as rdv
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.data import formats as tfmt
from ddstore_tpu_torch.data import graphs as tgr
from ddstore_tpu_torch.data.dataset import DistributedSampler
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.examples import gnn_molecules
from ddstore_tpu_torch.models import gnn as tgnn
from ddstore_tpu_torch.store import DDStore
from torch_parity import flat_leaves
from torch_workers import gnn_ddp_step, run_threads, spawn

pytestmark = pytest.mark.tier1_required

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SMALL = dict(hidden=32, layers=2)
G = 8  # graphs per slot


def _fields_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(fn=5, fe=2, t=3),
                                dict(min_nodes=2, max_nodes=30),
                                dict(stamp=4.0)])
def test_synthetic_graphs_bit_equal(kw):
    got = tgr.synthetic_graphs(np.random.default_rng(3), 20, **kw)
    want = rgr.synthetic_graphs(np.random.default_rng(3), 20, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _fields_equal(a, b)


@pytest.mark.parametrize("slots,budgets", [
    (2, (8 * 12, 8 * 36)),    # sized so nothing is skipped
    (3, (40, 120)),           # overflow: graphs skipped, slots masked
    (4, (8 * 12, 8 * 36))])   # fewer graphs than slots x G
def test_pack_graph_batch_matches_reference(slots, budgets):
    graphs = rgr.synthetic_graphs(np.random.default_rng(1), 2 * G + 3)
    got = tgr.pack_graph_batch(graphs, slots, G, *budgets)
    want = rgr.pack_graph_batch(graphs, slots, G, *budgets)
    _fields_equal(got, want)
    if budgets == (40, 120):
        assert not want.graph_mask.all()


def test_graph_dataset_fetch_matches_reference():
    world, per_rank = 2, 24
    res = {}
    for key, make, group in (("ref", RefStore, RefThreadGroup),
                             ("port", DDStore, rdv.ThreadGroup)):
        def fn(r, make=make, group=group, key=key):
            # rank 1's graphs are larger: the budgets are the group's max
            graphs = rgr.synthetic_graphs(np.random.default_rng(r),
                                          per_rank, max_nodes=12 + 4 * r)
            mod = rgr if key == "ref" else tgr
            with make(group(f"gds-{key}", r, world),
                      backend="local") as s:
                ds = mod.GraphShardedDataset(s, graphs, graphs_per_slot=4)
                idx = np.random.default_rng(10 + r).integers(
                    0, world * per_rank, size=12)
                out = (len(ds), ds.node_budget, ds.edge_budget,
                       ds.fetch(idx), ds.fetch_graphs(idx[:3]))
                with pytest.raises(ValueError, match="graphs_per_slot"):
                    ds.fetch(idx[:6])
                with pytest.raises(ValueError, match="graphs_per_slot"):
                    ds.fetch(idx[:0])
                s.barrier()
                ds.free()
                assert s.variables() == []
                return out
        res[key] = run_threads(world, fn)
    # the budgets are the group's: G x the largest graph of any rank
    most = max(len(g.nodes) for r in range(world)
               for g in rgr.synthetic_graphs(np.random.default_rng(r),
                                             per_rank, max_nodes=12 + 4 * r))
    assert most > 12
    for got, want in zip(res["port"], res["ref"]):
        assert got[:3] == want[:3]
        assert got[1] == 4 * most
        _fields_equal(got[3], want[3])
        for a, b in zip(got[4], want[4]):
            _fields_equal(a, b)


def _write_molecules(tmp_path, gz):
    rng = np.random.default_rng(0)
    els = ["H", "C", "N", "O", "F"]
    files = []
    for f in range(2):
        mols = []
        for m in range(3):
            n = int(rng.integers(2, 7))
            mols.append(([els[i] for i in rng.integers(0, 5, n)],
                          rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
                          [float(f * 10 + m), *rng.normal(size=4)]))
        path = str(tmp_path / f"mol{f}.xyz") + (".gz" if gz else "")
        rfmt.write_xyz(path, mols)
        files.append(path)
    return files


@pytest.mark.parametrize("gz", [False, True])
def test_qm9_readers_match_reference(tmp_path, gz):
    files = _write_molecules(tmp_path, gz)
    # the port's writer writes the same bytes
    out = tmp_path / "out"
    out.mkdir()
    mols = rfmt.read_xyz(files[0])
    for mod in (tfmt, rfmt):
        mod.write_xyz(str(out / f"{mod is tfmt}.xyz.gz"), mols)
    with gzip.open(out / "True.xyz.gz", "rt") as f, \
            gzip.open(out / "False.xyz.gz", "rt") as g:
        assert f.read() == g.read()
    opener = gzip.open if gz else open
    # QM9's trailer lines and Mathematica exponents parse the same way
    with opener(files[1], "at") as f:
        f.write("123.4\t567.8\nC[C@H]\tCC\nInChI=1S/x\n")
    for path in files:
        got, want = tfmt.read_xyz(path), rfmt.read_xyz(path)
        assert len(got) == len(want) == 3
        for (s1, c1, p1), (s2, c2, p2) in zip(got, want):
            assert s1 == s2
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(p1, p2)
        for mol in want:
            for cutoff in (1.0, 1.7):
                _fields_equal(tfmt.molecule_to_graph(*mol, target_index=2,
                                                     cutoff=cutoff),
                              rfmt.molecule_to_graph(*mol, target_index=2,
                                                     cutoff=cutoff))
    assert tfmt._parse_float("1.5*^-3") == rfmt._parse_float("1.5*^-3")
    for limit in (None, 4):
        got = tfmt.load_qm9_dir(str(tmp_path), target_index=1, limit=limit)
        want = rfmt.load_qm9_dir(str(tmp_path), target_index=1, limit=limit)
        assert len(got) == len(want) == (limit or 6)
        for a, b in zip(got, want):
            _fields_equal(a, b)
    with pytest.raises(ValueError, match="unknown element"):
        tfmt.molecule_to_graph(["X"], np.zeros((1, 3)), np.zeros(2))


@functools.lru_cache(maxsize=None)
def _params(seed):
    """Flax MPNN parameters (f32 whatever the compute dtype), with biases
    and LayerNorms moved off zero and identity, so a parameter mapped to
    the wrong layer shows."""
    jm = jgnn.MPNN(n_graphs=G, **SMALL)
    params = jm.init(jax.random.key(seed),
                     *(jnp.asarray(f[0]) for f in batch()[:7]))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed + 1)
    for mod in params["params"].values():
        if "scale" in mod:
            mod["scale"] += rng.uniform(-0.3, 0.3, mod["scale"].shape) \
                .astype(np.float32)
        mod["bias"] += rng.normal(0, 0.1, mod["bias"].shape) \
            .astype(np.float32)
    return params


def mpnn_pair(dtype=jnp.float32, seed=0):
    """(flax MPNN, its params as numpy, the port's MPNN with those
    weights), on the batches of :func:`batch`."""
    params = jax.tree_util.tree_map(np.copy, _params(seed))
    jm = jgnn.MPNN(compute_dtype=dtype, n_graphs=G, **SMALL)
    tm = tgnn.MPNN(compute_dtype=_TORCH[dtype], n_graphs=G, device="cpu",
                   **SMALL)
    weights.from_flax(params, tm)
    return jm, params, tm


def batch(slots=8, seed=2):
    """D packed slots with padding nodes and edges in every slot, and a
    node budget tight enough that some graphs are skipped."""
    graphs = rgr.synthetic_graphs(np.random.default_rng(seed), slots * G)
    return rgr.pack_graph_batch(graphs, slots, G, node_budget=70,
                                edge_budget=8 * 36)


def _torch_batch(gb):
    return tgr.GraphBatch(*(torch.from_numpy(np.asarray(f)) for f in gb))


def _jax_loss_grads(jm, params, gb):
    def lossf(p):
        pred = jgnn._apply_batch(jm, p, gb)
        return jgnn.loss_fn(pred, gb.y, gb.graph_mask)

    loss, grads = jax.jit(jax.value_and_grad(lossf))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), grads


def _assert_leaves_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, f"{k}: {err} > {tol} x {scale}"


def test_tree_and_forward_shapes():
    jm, params, tm = mpnn_pair()
    assert weights.to_flax(tm)["params"].keys() == params["params"].keys()
    for k, v in flat_leaves(params["params"]).items():
        np.testing.assert_array_equal(
            flat_leaves(weights.to_flax(tm)["params"])[k], v)
    gb = batch()
    assert gb.graph_mask.sum() < gb.graph_mask.size  # some skipped
    assert (~gb.node_mask).any(axis=1).all()  # padding in every slot
    pred = tgnn.apply_batch(tm, _torch_batch(gb))
    assert pred.shape == (8, G, 1) and pred.dtype == torch.float32
    # ZeRO-3 follows the mesh (tests/test_torch_fsdp.py places it over
    # dp x fsdp); without one the state leaves the parameters whole
    state, _ = tgnn.create_train_state(tm)
    assert state.mesh is None
    assert not any(hasattr(p, "placements") for p in tm.parameters())


@pytest.mark.parametrize("dtype,rtol,atol", [(jnp.float32, 1e-5, 1e-6),
                                             (jnp.bfloat16, 0, 2e-2)])
def test_forward_matches_flax_vmap(dtype, rtol, atol):
    jm, params, tm = mpnn_pair(dtype)
    gb = batch()
    want = np.asarray(jgnn._apply_batch(
        jm, jax.tree_util.tree_map(jnp.asarray, params), gb))
    got = tgnn.apply_batch(tm, _torch_batch(gb)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,loss_rtol,grad_tol,step_atol",
                         [(jnp.float32, 1e-5, 1e-4, 1e-5),
                          (jnp.bfloat16, 2e-2, 5e-2, 5e-3)])
def test_loss_gradients_and_adam_step_match(dtype, loss_rtol, grad_tol,
                                            step_atol):
    jm, params, tm = mpnn_pair(dtype)
    gb = batch()
    want_loss, want_grads = _jax_loss_grads(jm, params, gb)
    # the eval step: the same loss, no gradients
    np.testing.assert_allclose(
        float(tgnn.make_eval_step(tm)(_torch_batch(gb))), want_loss,
        rtol=loss_rtol)
    assert all(p.grad is None for p in tm.parameters())
    # lr 1e-3, as the reference's step test: Adam's first update is
    # +-lr wherever the gradient's sign is not pinned at bf16
    _, opt = tgnn.create_train_state(tm)
    state = tgnn.TrainState(tm, opt)
    loss = tgnn.make_train_step(tm, opt, state=state)(_torch_batch(gb))
    assert state.step == 1
    np.testing.assert_allclose(float(loss), want_loss, rtol=loss_rtol)
    got = flat_leaves(weights.to_flax(
        {k: p.grad for k, p in tm.named_parameters()})["params"])
    _assert_leaves_close(got, flat_leaves(want_grads["params"]), grad_tol)
    tx = optax.adam(1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(want_grads, tx.init(jparams), jparams)
    want = flat_leaves(optax.apply_updates(jparams, updates)["params"])
    got = flat_leaves(weights.to_flax(tm)["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=step_atol,
                                   err_msg=k)


def test_ddp_step_matches_jax_on_the_concatenated_batch(tmp_path):
    jm, params, _ = mpnn_pair()
    gb = batch(slots=2)
    # a different number of real graphs on each rank
    mask = gb.graph_mask.copy()
    mask[0, 5:] = False
    gb = gb._replace(graph_mask=mask)
    assert gb.graph_mask[0].sum() != gb.graph_mask[1].sum()
    want_loss, want_grads = _jax_loss_grads(jm, params, gb)
    tx = optax.adam(1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = tx.update(want_grads, tx.init(jparams), jparams)
    want_params = flat_leaves(optax.apply_updates(jparams, updates)["params"])
    ranks = spawn(2, gnn_ddp_step, str(tmp_path), params,
                  tuple(np.asarray(f) for f in gb))
    for loss, grads, after in ranks:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        _assert_leaves_close(flat_leaves(grads["params"]),
                             flat_leaves(want_grads["params"]), 1e-4)
        got = flat_leaves(after["params"])
        for k in want_params:
            np.testing.assert_allclose(got[k], want_params[k], atol=1e-5,
                                       err_msg=k)


def test_store_fed_training_loss_decreases():
    graphs = tgr.synthetic_graphs(np.random.default_rng(1), 256)
    with DDStore(backend="local") as store:
        ds = tgr.GraphShardedDataset(store, graphs, graphs_per_slot=G)
        model = tgnn.MPNN(device="cpu", **SMALL).init_weights(
            torch.Generator().manual_seed(0))
        _, opt = tgnn.create_train_state(model, lr=3e-3)
        step = tgnn.make_train_step(model, opt)
        sampler = DistributedSampler(len(ds), 1, 0, seed=0)
        losses = []
        for epoch in range(3):
            sampler.set_epoch(epoch)
            loader = DeviceLoader(ds, sampler, 2 * G, device="cpu")
            tot = 0.0
            for gb in loader:
                assert isinstance(gb, tgr.GraphBatch)  # the type survives
                assert gb.nodes.shape[0] == 2
                tot += float(step(gb))
            losses.append(tot)
        assert losses[-1] < losses[0] * 0.7, losses
        assert loader.readahead_fallback_reason is None


@pytest.mark.parametrize("data", ["synthetic", "xyz"])
def test_example_runs_on_the_cpu(tmp_path, capsys, data):
    argv = ["--device", "cpu", "--steps", "2", "--epochs", "1",
            "--graphs", "64"]
    if data == "xyz":
        _write_molecules(tmp_path, gz=False)
        argv += ["--data-dir", str(tmp_path), "--graphs-per-slot", "2"]
    gnn_molecules.main(argv)
    out = capsys.readouterr().out
    assert "epoch 0: loss=" in out and "graphs/s=" in out
    loss = float(out.split("loss=")[1].split()[0])
    assert np.isfinite(loss)
