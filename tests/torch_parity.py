"""Shared set-up of the parity tests between ``ddstore_tpu`` (JAX, the
reference) and ``ddstore_tpu_torch`` (the port): one LM built in both
packages from the same numpy weights. Everything runs on the CPU; data
crosses between the frameworks as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ddstore_tpu.models import transformer as jtr
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import transformer as ttr

SMALL = dict(vocab=256, dim=64, heads=4, layers=2)

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16}


def lm_pair(dtype=jnp.float32, seed=0, **kw):
    """(flax model, its params, the port's model with the same weights).
    The LayerNorms are moved off identity (scale 1, bias 0), so that a
    LayerNorm applied twice, or with the wrong epsilon, shows."""
    cfg = dict(SMALL, **kw)
    jm = jtr.TransformerLM(compute_dtype=dtype, **cfg)
    params = jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32),
                     jnp.tile(jnp.arange(8), (1, 1)))
    params = jax.tree_util.tree_map(np.array, params)  # writable copies
    rng = np.random.default_rng(seed + 100)
    for path, leaf in _leaves(params["params"]):
        if path[-1] == "scale":
            leaf += rng.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
        elif path[-1] == "bias":
            leaf += rng.normal(0, 0.2, leaf.shape).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tm = ttr.TransformerLM(compute_dtype=_TORCH_DTYPE[dtype], device="cpu",
                           **cfg)
    weights.from_flax(jax.tree_util.tree_map(np.asarray, params), tm)
    return jm, params, tm


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def flat_leaves(tree):
    """{"a/b/c": f32 numpy leaf} of a nested dict of arrays (a flax tree,
    or ``weights.to_flax``'s)."""
    return {"/".join(path): np.asarray(leaf, np.float32)
            for path, leaf in _leaves(tree)}


def tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def positions(b, s):
    return np.tile(np.arange(s, dtype=np.int32), (b, 1))


def jax_lm_step(jm, params, batch, lr):
    """One Adam step of the reference's single-device LM step on the whole
    batch: (loss, parameters after, gradients), as numpy."""
    import optax

    tx = optax.adam(lr)
    state = jtr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    batch = tuple(jnp.asarray(a) for a in batch)
    new, loss = jtr.make_train_step(jm, tx, donate=False)(state, *batch)
    grads = jax.grad(lambda p: jtr.lm_loss(jm, p, *batch))(params)
    return (float(loss), jax.tree_util.tree_map(np.asarray, new.params),
            jax.tree_util.tree_map(np.asarray, grads))


# Adam's first update is lr * g / (|g| + 1e-8): where the reference's
# gradient is within ten eps of 0 the frameworks' f32 summation noise
# (1e-10 on gradients of 1e-2 here) moves it by more than 1e-2 of lr, so
# there the gradient itself is held (GRAD_TOL) instead of the update.
ADAM_NOISE_FLOOR = 1e-7
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def assert_updates_close(got, want, before, lr, got_grads, want_grads,
                         tol=1e-2, leaf_scale=False):
    """Each parameter's gradient within ``GRAD_TOL`` of the reference's
    (``leaf_scale``: its largest error within 1e-4 of the leaf's largest
    gradient, the rule of the VAE's and GNN's DDP tests, whose summed
    losses give gradients of order 1), and its update (after less before)
    within ``tol`` of the learning rate of the reference's wherever the
    reference's gradient is above ``ADAM_NOISE_FLOOR``: Adam's first step
    is +-lr there, so this holds each update to its sign and size."""
    got, want, before = flat_leaves(got), flat_leaves(want), \
        flat_leaves(before)
    got_grads, want_grads = flat_leaves(got_grads), flat_leaves(want_grads)
    assert sorted(got) == sorted(want) == sorted(want_grads)
    for path, w in want.items():
        if leaf_scale:
            err = float(np.abs(got_grads[path] - want_grads[path]).max())
            scale = max(float(np.abs(want_grads[path]).max()), 1e-30)
            assert err <= 1e-4 * scale, f"{path}: {err} > 1e-4 x {scale}"
        else:
            np.testing.assert_allclose(got_grads[path], want_grads[path],
                                       err_msg=path, **GRAD_TOL)
        live = np.abs(want_grads[path]) >= ADAM_NOISE_FLOOR
        np.testing.assert_allclose((got[path] - before[path])[live],
                                   (w - before[path])[live], rtol=0,
                                   atol=tol * lr, err_msg=path)


def rule_pairs(tm, params):
    """(torch name, torch parameter, flax path, flax leaf) of every
    parameter of the port's model ``tm`` and the flax tree ``params``."""
    from ddstore_tpu_torch.weights import flax_name

    flat = flat_leaves(params["params"] if "params" in params else params)
    for name, p in tm.named_parameters():
        key = flax_name(name)
        yield name, p, tuple(key.split("/")), flat[key]


def spec_in_torch(spec, path, ndim):
    """A reference ``PartitionSpec`` of the flax leaf at ``path`` as a
    tuple over the torch parameter's dims (Dense kernels transposed)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return spec[::-1] if path[-1] == "kernel" else spec
