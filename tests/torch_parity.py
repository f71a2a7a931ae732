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

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


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
