"""The port's checkpoints (``ddstore_tpu_torch.utils.checkpoint``)
against the JAX package's, case by case with ``tests/test_checkpoint.py``.

* Store shards: the file format is the JAX package's byte for byte.
  Every shard case runs with the files written by one package and
  loaded by the other (both directions), including the elastic 4 -> 2
  -> 8 re-split, the tiered (mmap) restore and the stale-generation
  cleanup, and the two packages' files of the same shards must be equal.
* Train state: a VAE trained k steps by the JAX package is carried into
  the port (``weights.from_flax``, the Adam moments included), saved and
  restored by the port, then trained m more steps by both, held to
  ``tests/test_torch_vae.py``'s loss tolerances (rtol 1e-5 in f32, 5e-3
  in bf16); a resumed port run reproduces the uninterrupted one bit for
  bit, and an async save is not reached by the optimizer step that
  follows it (torch updates parameters in place)."""

import threading
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.models import vae as jvae
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.models import vae as tvae
from ddstore_tpu_torch.store import DDStore
from ddstore_tpu_torch.utils import checkpoint as ck
from torch_parity import flat_leaves
from torch_services import PKGS

pytestmark = pytest.mark.tier1_required

OTHER = {"jax": "torch", "torch": "jax"}
_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _world(P, world, tag, body):
    """``body(store, rank)`` on ``world`` threads, each rank a local
    store of package ``P`` in one ThreadGroup."""
    errs = []

    def member(rank):
        try:
            g = P.ThreadGroup(tag, rank, world)
            with P.DDStore(g, backend="local") as s:
                body(s, rank)
                s.barrier()
        except Exception:  # noqa: BLE001 — reported below
            errs.append((rank, traceback.format_exc()))

    ts = [threading.Thread(target=member, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs, errs
    assert not any(t.is_alive() for t in ts)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# -- train state ------------------------------------------------------------

def _jax_state(dtype, k, seed=0):
    """The JAX VAE after ``k`` Adam steps on seeded batches, with the
    batches and keys of ``m`` more."""
    model = jvae.VAE(compute_dtype=dtype)
    _, state, tx = jvae.create_train_state(jax.random.key(seed),
                                           model=model)
    step = jvae.make_train_step(model, tx, donate=False)
    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, 256, (16, 784), dtype=np.uint8)
               for _ in range(k + 2)]
    keys = [jax.random.key(100 + i) for i in range(k + 2)]
    for i in range(k):
        state, _ = step(state, jnp.asarray(batches[i]), keys[i])
    return model, state, step, batches[k:], keys[k:]


def _eps(key, n):
    """The draw the flax VAE makes from ``key`` (vae.py:66)."""
    return torch.from_numpy(np.array(jax.random.normal(
        key, (n, tvae.LATENT), jnp.float32)))


def _port_from_jax(state, dtype):
    """The port's VAE and Adam carrying the JAX state: parameters,
    both moments and the step count."""
    model = tvae.VAE(compute_dtype=_TORCH[dtype], device="cpu")
    weights.from_flax(jax.tree_util.tree_map(np.asarray, state.params),
                      model)
    _, opt = tvae.create_train_state(model)
    adam = state.opt_state[0]
    moments = [dict(weights.from_flax(
        jax.tree_util.tree_map(np.asarray, tree),
        tvae.VAE(device="cpu")).named_parameters()) for tree in
        (adam.mu, adam.nu)]
    for n, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(adam.count)),
                        "exp_avg": moments[0][n].detach().clone(),
                        "exp_avg_sq": moments[1][n].detach().clone()}
    return model, opt


def _state_of(model, opt):
    return {"model": model.state_dict(), "opt": opt.state_dict()}


def _fresh(dtype):
    model = tvae.VAE(compute_dtype=_TORCH[dtype], device="cpu")
    return model, tvae.create_train_state(model)[1]


@pytest.mark.parametrize("dtype,loss_rtol", [(jnp.float32, 1e-5),
                                             (jnp.bfloat16, 5e-3)])
def test_train_state_roundtrip(tmp_path, dtype, loss_rtol):
    _, state, step, batches, keys = _jax_state(dtype, k=2)
    model, opt = _port_from_jax(state, dtype)
    ck.save_train_state(str(tmp_path / "ckpt.pt"), _state_of(model, opt))

    fresh, fresh_opt = _fresh(dtype)
    restored = ck.restore_train_state(str(tmp_path / "ckpt.pt"),
                                      _state_of(fresh, fresh_opt))
    fresh.load_state_dict(restored["model"])
    fresh_opt.load_state_dict(restored["opt"])
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    for p, q in zip(model.parameters(), fresh.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key],
                               fresh_opt.state[q][key]), key

    tstep = tvae.make_train_step(fresh, fresh_opt)
    for raw, key in zip(batches, keys):
        state, want = step(state, jnp.asarray(raw), key)
        got = tstep(torch.from_numpy(raw), eps=_eps(key, len(raw)))
        np.testing.assert_allclose(float(got), float(want), rtol=loss_rtol)
    if dtype == jnp.float32:  # the parameters after the resumed steps
        got = flat_leaves(weights.to_flax(fresh)["params"])
        want = flat_leaves(jax.tree_util.tree_map(
            np.asarray, state.params)["params"])
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6)


def test_train_state_restore_checks_structure(tmp_path):
    model, opt = _fresh(jnp.float32)
    ck.save_train_state(str(tmp_path / "a.pt"), _state_of(model, opt))
    small = tvae.VAE(hidden=8, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.restore_train_state(str(tmp_path / "a.pt"),
                               {"model": small.state_dict(),
                                "opt": opt.state_dict()})
    with pytest.raises(ValueError, match="keys"):
        ck.restore_train_state(str(tmp_path / "a.pt"),
                               {"model": model.state_dict()})


def test_restore_places_only_what_like_holds(tmp_path):
    """A tensor with a counterpart in ``like`` takes its device and
    dtype; the rest (a fresh optimizer's state) stays on the host for
    ``load_state_dict`` to place, so Adam's ``step`` is not moved to the
    parameters' device. The ``meta`` device stands in for a card."""
    model, opt = _fresh(jnp.float32)
    tvae.make_train_step(model, opt)(
        torch.rand((8, tvae.IMAGE_DIM),
                   generator=torch.Generator().manual_seed(0)),
        generator=torch.Generator().manual_seed(1))
    ck.save_train_state(str(tmp_path / "p.pt"), _state_of(model, opt))
    like_model = tvae.VAE(device="meta")
    like_opt = tvae.create_train_state(like_model)[1]
    like = _state_of(like_model, like_opt)
    like["model"] = {k: v.to(torch.float64)
                     for k, v in like["model"].items()}
    got = ck.restore_train_state(str(tmp_path / "p.pt"), like)
    for k, v in got["model"].items():
        assert (v.device.type, v.dtype) == ("meta", torch.float64), k
    state = got["opt"]["state"]
    assert len(state) == len(list(model.parameters()))
    for i, st in state.items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert st[key].device.type == "cpu", (i, key)
            assert st[key].dtype == torch.float32, (i, key)


def test_shard_roundtrip_multirank(tmp_path):
    world, rows, dim = 4, 16, 3
    for writer in ("jax", "torch"):
        d = tmp_path / writer

        def save(s, rank):
            s.add("v", np.full((rows, dim), rank + 1, np.float32))
            PKGS[writer].save_shard(s, "v", str(d))

        _world(PKGS[writer], world, f"ck-save-{writer}-{tmp_path}", save)

        def load(s, rank, P=PKGS[OTHER[writer]]):
            P.load_shard(s, "v", str(d))
            got = s.get_batch("v", np.arange(world * rows))
            np.testing.assert_array_equal(
                got, (np.arange(world * rows) // rows + 1)[:, None]
                * np.ones((1, dim), np.float32))
            s.free("v")
            P.load_shard(s, "v", str(d), mmap=True)
            np.testing.assert_array_equal(
                s.get_batch("v", np.arange(world * rows)), got)

        _world(PKGS[OTHER[writer]], world, f"ck-load-{writer}-{tmp_path}",
               load)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_shard_roundtrip_with_empty_rank(tmp_path):
    for writer in ("jax", "torch"):
        d = tmp_path / writer

        def save(s, rank):
            s.add("v", np.full((8 if rank == 0 else 0, 2), rank + 1,
                               np.float32))
            PKGS[writer].save_shard(s, "v", str(d))

        _world(PKGS[writer], 2, f"ckz-save-{writer}-{tmp_path}", save)

        def load(s, rank, P=PKGS[OTHER[writer]]):
            for mmap in (False, True):
                P.load_shard(s, "v", str(d), mmap=mmap)
                assert (s.get_batch("v", np.arange(8)) == 1).all()
                s.free("v")

        _world(PKGS[OTHER[writer]], 2, f"ckz-load-{writer}-{tmp_path}",
               load)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_resume_reproduces_uninterrupted_run(tmp_path):
    """Port: 4 steps straight against 2 + save + restore + 2 on a fresh
    model, bit for bit; the straight run's losses against the JAX
    package's steps on the same batches and draws (rtol 1e-5, f32)."""
    data = np.random.default_rng(0).random((256, 784), dtype=np.float32)
    jm, jstate, _ = jvae.create_train_state(
        jax.random.key(0), model=jvae.VAE(compute_dtype=jnp.float32))
    init = jax.tree_util.tree_map(np.asarray, jstate.params)

    def run(n_steps, model=None, opt=None, start=0):
        if model is None:
            model = weights.from_flax(init, tvae.VAE(
                compute_dtype=torch.float32, device="cpu"))
            opt = tvae.create_train_state(model)[1]
        step = tvae.make_train_step(model, opt)
        losses, seen = [], []
        with DDStore(backend="local") as store:
            ds = ShardedDataset(store, data)
            sampler = DistributedSampler(len(ds), 1, 0, seed=0)
            sampler.set_epoch(0)
            for i, xb in enumerate(DeviceLoader(ds, sampler, 64,
                                                device="cpu")):
                if i < start:
                    continue  # deterministic replay of the index stream
                if i >= n_steps:
                    break
                seen.append(xb.numpy().copy())
                losses.append(float(step(xb, eps=_eps(
                    jax.random.key(100 + i), 64))))
        return model, opt, losses, seen

    straight, _, losses, seen = run(4)
    half, half_opt, _, _ = run(2)
    ck.save_train_state(str(tmp_path / "ck.pt"), _state_of(half, half_opt))
    model, opt = _fresh(jnp.float32)
    restored = ck.restore_train_state(str(tmp_path / "ck.pt"),
                                      _state_of(model, opt))
    model.load_state_dict(restored["model"])
    opt.load_state_dict(restored["opt"])
    final, _, _, _ = run(4, model, opt, start=2)
    for (n, a), b in zip(straight.state_dict().items(),
                         final.state_dict().values()):
        assert torch.equal(a, b), n

    tx_step = jvae.make_train_step(jm, jvae.create_train_state(
        jax.random.key(0), model=jm)[2], donate=False)
    for i, xb in enumerate(seen):
        jstate, want = tx_step(jstate, jnp.asarray(xb),
                               jax.random.key(100 + i))
        np.testing.assert_allclose(losses[i], float(want), rtol=1e-5)


def test_async_save_restore(tmp_path):
    """Async save overlaps the train loop; after wait() the checkpoint
    restores bit-identically to a blocking save of the same state."""
    model, opt = _fresh(jnp.float32)
    step = tvae.make_train_step(model, opt)
    x = torch.zeros((4, tvae.IMAGE_DIM))
    gen = torch.Generator().manual_seed(4)
    step(x, generator=gen)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with ck.save_train_state_async(str(tmp_path / "async.pt"),
                                   _state_of(model, opt)):
        step(x, generator=gen)  # training continues during the write
    # the blocking save of the state the async one captured
    m2, o2 = _fresh(jnp.float32)
    m2.load_state_dict(want)
    ck.save_train_state(str(tmp_path / "sync.pt"),
                        {"model": m2.state_dict()})
    got = ck.restore_train_state(str(tmp_path / "async.pt"),
                                 _state_of(*_fresh(jnp.float32)))
    sync = ck.restore_train_state(str(tmp_path / "sync.pt"),
                                  {"model": _fresh(jnp.float32)[0]
                                   .state_dict()})
    for k in want:
        assert torch.equal(got["model"][k], sync["model"][k]), k
        assert torch.equal(got["model"][k], want[k]), k
    assert got["opt"]["state"][0]["step"] == 1


def test_async_save_is_not_reached_by_the_next_step(tmp_path,
                                                    monkeypatch):
    """The in-place hazard: the write is held back until the optimizer
    has stepped the parameters and both Adam moments in place; the file
    still holds the state of the call."""
    model, opt = _fresh(jnp.float32)
    step = tvae.make_train_step(model, opt)
    x = torch.rand((8, tvae.IMAGE_DIM), generator=torch.Generator()
                   .manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    step(x, generator=gen)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: opt.state[p]["exp_avg_sq"].clone()
               for k, p in model.named_parameters()}
    stepped = threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        assert stepped.wait(30)
        real_save(obj, path)

    monkeypatch.setattr(ck.torch, "save", held_save)
    handle = ck.save_train_state_async(str(tmp_path / "s.pt"),
                                       _state_of(model, opt))
    step(x, generator=gen)  # in place: parameters and moments change
    stepped.set()
    handle.wait()
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())
    got = ck.restore_train_state(str(tmp_path / "s.pt"),
                                 _state_of(*_fresh(jnp.float32)))
    for k, v in before.items():
        assert torch.equal(got["model"][k], v), k
    names = [n for n, _ in model.named_parameters()]
    for i, n in enumerate(names):
        assert torch.equal(got["opt"]["state"][i]["exp_avg_sq"],
                           moments[n]), n


def test_elastic_reshard_4_to_2_and_back(tmp_path):
    """Saved at world 4 by one package, reloaded by the other at worlds
    2, 8, 2 (tiered) and 3: every global row served unchanged."""
    rows_per, dim = 8, 3
    total = 4 * rows_per
    want = np.arange(total)[:, None] * np.ones((1, dim))
    for writer in ("jax", "torch"):
        d = tmp_path / writer

        def save(s, rank):
            base = rank * rows_per
            s.add("v", (np.arange(rows_per)[:, None] + base)
                  * np.ones((1, dim), np.float64))
            PKGS[writer].save_shard(s, "v", str(d))

        _world(PKGS[writer], 4, f"el-{writer}-{tmp_path}", save)
        reader = PKGS[OTHER[writer]]
        for world, mmap in ((2, False), (8, False), (2, True), (3, False)):
            def load(s, rank, mmap=mmap):
                reader.load_shard(s, "v", str(d), mmap=mmap)
                np.testing.assert_array_equal(
                    s.get_batch("v", np.arange(total)), want)

            _world(reader, world, f"el-{writer}-{world}-{mmap}-{tmp_path}",
                   load)
    # the tiered re-split scratch files are the same bytes too
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")


def test_elastic_resave_invalidates_stale_generation(tmp_path):
    """Generation 1 saved at world 4, generation 2 at world 2 (which
    must unlink ranks 2-3's stale files), resumed at world 4: every rank
    serves generation 2, whichever package wrote and which reads."""
    rows_per, dim = 8, 2
    total = 4 * rows_per
    for writer in ("jax", "torch"):
        d = str(tmp_path / writer)
        P, Q = PKGS[writer], PKGS[OTHER[writer]]

        def gen1(s, rank):
            s.add("v", (np.arange(rows_per)[:, None] + rank * rows_per)
                  * np.ones((1, dim), np.float64))
            P.save_shard(s, "v", d)

        def gen2(s, rank):
            per = total // 2
            s.add("v", (np.arange(per)[:, None] + rank * per + 1000.0)
                  * np.ones((1, dim), np.float64))
            Q.save_shard(s, "v", d)  # the other package re-saves

        def check(s, rank):
            P.load_shard(s, "v", d)
            np.testing.assert_array_equal(
                s.get_batch("v", np.arange(total)),
                (np.arange(total)[:, None] + 1000.0) * np.ones((1, dim)))

        _world(P, 4, f"g1-{writer}-{tmp_path}", gen1)
        _world(Q, 2, f"g2-{writer}-{tmp_path}", gen2)
        _world(P, 4, f"g3-{writer}-{tmp_path}", check)
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
