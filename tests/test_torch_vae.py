"""Parity of the port's VAE (``ddstore_tpu_torch.models.vae``) with the
flax VAE it ports, on the CPU, from the same weights
(``weights.from_flax``) and the same ``eps`` (the draw the flax model
makes from its key, passed to the port explicitly).

Tolerances: at ``compute_dtype=float32`` the loss to rtol 1e-5 and each
gradient leaf to 1e-4 of that leaf's largest magnitude; at bfloat16 (the
hidden layers round to 8 bits) the loss to rtol 5e-3 and each leaf to
2e-2. One Adam step against optax at f32 to 1e-6. The uint8 path against
pre-divided floats exactly. The two-rank DDP step (gloo, spawned
processes) against the JAX single-process step on the concatenated batch
at the f32 tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu.data import formats as rfmt
from ddstore_tpu.models import vae as jvae
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.data import formats as tfmt
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.models import vae as tvae
from ddstore_tpu_torch.store import DDStore
from torch_parity import flat_leaves
from torch_workers import spawn, vae_ddp_step, vae_store_fed

pytestmark = pytest.mark.tier1_required

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def vae_pair(dtype=jnp.float32, seed=0):
    """(flax VAE, its params as numpy, the port's VAE with those weights).
    Biases are moved off zero, so a bias mapped to the wrong layer
    shows."""
    jm = jvae.VAE(compute_dtype=dtype)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 784)),
                     jax.random.key(0))
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed + 1)
    for mod in params["params"].values():
        for dense in mod.values():
            dense["bias"] += rng.normal(0, 0.1, dense["bias"].shape) \
                .astype(np.float32)
    tm = tvae.VAE(compute_dtype=_TORCH[dtype], device="cpu")
    weights.from_flax(params, tm)
    return jm, params, tm


def batch_and_eps(n, seed=3):
    raw = np.random.default_rng(seed).integers(0, 256, (n, 784),
                                               dtype=np.uint8)
    key = jax.random.key(seed + 1)
    # the draw VAE.__call__ makes from its key (vae.py:66)
    eps = np.array(jax.random.normal(key, (n, tvae.LATENT), jnp.float32))
    return raw, key, eps


def jax_loss_and_grads(jm, params, raw, key):
    x = jnp.asarray(raw, jnp.float32) / 255.0

    def lossf(p):
        logits, mu, logvar = jm.apply(p, x, key)
        return jvae.loss_fn(logits, x, mu, logvar)

    loss, grads = jax.value_and_grad(lossf)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), flat_leaves(grads["params"])


def assert_leaves_close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, f"{k}: {err} > {tol} x {scale}"


def test_forward_shapes():
    model = tvae.VAE(device="cpu")
    logits, mu, logvar = model(torch.zeros(4, 28, 28),
                               generator=torch.Generator().manual_seed(0))
    assert logits.shape == (4, 784) and logits.dtype == torch.float32
    assert mu.shape == logvar.shape == (4, 20)
    assert mu.dtype == logvar.dtype == torch.float32
    assert model.generate(torch.zeros(3, 20)).shape == (3, 784)
    jm, params, tm = vae_pair()
    assert weights.to_flax(tm)["params"].keys() == params["params"].keys()
    for k, v in flat_leaves(params["params"]).items():
        np.testing.assert_array_equal(
            flat_leaves(weights.to_flax(tm)["params"])[k], v)


@pytest.mark.parametrize("dtype,loss_rtol,grad_tol",
                         [(jnp.float32, 1e-5, 1e-4),
                          (jnp.bfloat16, 5e-3, 2e-2)])
def test_loss_and_gradients_match_jax(dtype, loss_rtol, grad_tol):
    jm, params, tm = vae_pair(dtype)
    raw, key, eps = batch_and_eps(16)
    want_loss, want_grads = jax_loss_and_grads(jm, params, raw, key)
    x = tvae._dequantize(torch.from_numpy(raw))
    logits, mu, logvar = tm(x, eps=torch.from_numpy(eps))
    loss = tvae.loss_fn(logits, x, mu, logvar)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=loss_rtol)
    got = flat_leaves(weights.to_flax(
        {k: p.grad for k, p in tm.named_parameters()})["params"])
    assert_leaves_close(got, want_grads, grad_tol)


def test_adam_steps_match_optax():
    _, params, tm = vae_pair()
    _, opt = tvae.create_train_state(tm)
    tx = optax.adam(1e-3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    names = dict(tm.named_parameters())
    rng = np.random.default_rng(7)
    for _ in range(2):  # the second step reads both moments
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
        scratch = weights.from_flax(grads, tvae.VAE(device="cpu"))
        for n, g in scratch.named_parameters():
            names[n].grad = g.detach().clone()
        opt.step()
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    got = flat_leaves(weights.to_flax(tm)["params"])
    for k, want in flat_leaves(jparams["params"]).items():
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-6)


def test_uint8_batch_matches_normalized_float():
    raw = np.random.default_rng(0).integers(0, 256, (16, 784),
                                            dtype=np.uint8)
    eps = torch.from_numpy(batch_and_eps(16)[2])
    out = []
    for batch in (torch.from_numpy(raw),
                  torch.from_numpy(raw.astype(np.float32) / 255.0)):
        model = tvae.VAE(device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        _, opt = tvae.create_train_state(model)
        loss = tvae.make_train_step(model, opt)(batch, eps=eps)
        ev = tvae.make_eval_step(model)(batch, eps=eps)
        out.append((loss, ev, [p.detach().clone()
                               for p in model.parameters()]))
    (la, ea, pa), (lb, eb, pb) = out
    assert torch.equal(la, lb) and torch.equal(ea, eb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_mnist_idx_files_match_reference(tmp_path, suffix):
    images, labels = tfmt.synthetic_mnist(50, seed=4)
    want_images, want_labels = rfmt.synthetic_mnist(50, seed=4)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)
    # written by the port, read by both; the reference's files by the port
    tfmt.write_idx(str(tmp_path / ("train-images-idx3-ubyte" + suffix)),
                   images.reshape(50, 28, 28))
    rfmt.write_idx(str(tmp_path / ("train-labels-idx1-ubyte" + suffix)),
                   labels)
    assert tfmt.find_mnist(str(tmp_path)) == rfmt.find_mnist(str(tmp_path))
    assert tfmt.find_mnist(str(tmp_path), "test") is None
    for normalize in (False, True):
        got = tfmt.load_mnist(str(tmp_path), normalize=normalize)
        want = rfmt.load_mnist(str(tmp_path), normalize=normalize)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x00\x00\x09\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="bad idx magic"):
        tfmt.read_idx(str(bad))


def test_dequantize_is_true_division():
    raw = torch.arange(256, dtype=torch.uint8)
    want = torch.from_numpy(np.arange(256, dtype=np.float32) / 255.0)
    assert torch.equal(tvae._dequantize(raw), want)
    f = torch.rand(3)
    assert tvae._dequantize(f) is f


def test_ddp_step_matches_jax_on_the_concatenated_batch(tmp_path):
    jm, params, _ = vae_pair()
    raw, key, eps = batch_and_eps(16)
    want_loss, want_grads = jax_loss_and_grads(jm, params, raw, key)
    ranks = spawn(2, vae_ddp_step, str(tmp_path), params, raw, eps)
    for loss, grads, _ in ranks:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        assert_leaves_close(flat_leaves(grads["params"]), want_grads, 1e-4)
    (_, g0, p0), (_, g1, p1) = ranks
    for a, b in ((g0, g1), (p0, p1)):  # every rank holds the same
        fa, fb = flat_leaves(a["params"]), flat_leaves(b["params"])
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_store_fed_training_loss_decreases():
    g = np.random.default_rng(0)
    centers = g.random((10, 784), dtype=np.float32)
    labels = g.integers(0, 10, size=512).astype(np.int32)
    data = (centers[labels] * 0.8 + 0.2 *
            g.random((512, 784), dtype=np.float32)).astype(np.float32)
    with DDStore() as store:
        ds = ShardedDataset(store, data, labels)
        model = tvae.VAE(device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        _, opt = tvae.create_train_state(model)
        step = tvae.make_train_step(model, opt)
        sampler = DistributedSampler(len(ds), 1, 0, seed=0)
        gen = torch.Generator().manual_seed(1)
        losses = []
        for epoch in range(3):
            sampler.set_epoch(epoch)
            loader = DeviceLoader(ds, sampler, 64, device="cpu",
                                  transform=lambda b: b[0])
            losses.append(sum(float(step(xb, generator=gen))
                              for xb in loader))
        assert losses[2] < losses[1] < losses[0], losses
        assert losses[-1] < losses[0] * 0.99, losses
        eff = loader.metrics.summary()["input_pipeline_efficiency"]
        assert 0.0 <= eff <= 1.0


def test_store_fed_ddp_over_tcp(tmp_path):
    ranks = spawn(2, vae_store_fed, str(tmp_path), 512, 32, 3)
    for r in ranks:
        assert all(np.isfinite(r["losses"])), r["losses"]
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        # about half the rows of each batch live on the other rank
        remote = r["bytes_over_dcn"] / (r["rows"] * r["row_bytes"])
        assert 0.35 < remote < 0.65, remote
    # the summed loss is the same number on both ranks, and so are the
    # parameters after every step, bit for bit
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(set(ranks[0]["checksums"])) == 1
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
