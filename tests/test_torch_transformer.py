"""Parity of the port's TransformerLM, lm_loss and fused cross-entropy
with the JAX reference, on the CPU at a small size.

Tolerances: f32 logits atol 1e-4 (the two frameworks sum in different
orders); bf16 logits atol 3e-2 (bf16 rounds at about 4e-3 relative, and
activations pass through two blocks of bf16 matmuls before the f32
head)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.ops.xent import fused_linear_xent as j_xent
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.ops.xent import fused_linear_xent as t_xent

from torch_parity import lm_pair, positions, tokens

pytestmark = pytest.mark.tier1_required


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-4),
                                        (jnp.bfloat16, 3e-2)])
def test_logits_match_reference(dtype, atol):
    jm, params, tm = lm_pair(dtype)
    tok, pos = tokens(2, 64, jm.vocab), positions(2, 64)
    want = np.asarray(jm.apply(params, tok, pos), np.float32)
    got = tm(torch.from_numpy(tok), torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=atol,
                               rtol=0)


def test_features_and_kv_match_reference():
    jm, params, tm = lm_pair()
    tok, pos = tokens(2, 32, jm.vocab, seed=3), positions(2, 32)
    feats, inter = jm.clone(sow_kv=True).apply(
        params, tok, pos, True, mutable=("intermediates",))
    with torch.no_grad():
        got, kvs = tm(torch.from_numpy(tok), torch.from_numpy(pos),
                      return_features=True, return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(feats), atol=1e-4)
    assert len(kvs) == jm.layers
    for i, (k, v) in enumerate(kvs):
        (jk, jv), = inter["intermediates"][f"block{i}"]["kv"]
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-5),
                                        (jnp.bfloat16, 1e-2)])
def test_lm_loss_matches_reference(fused, dtype, atol):
    jm, params, tm = lm_pair(dtype)
    tok, pos = tokens(2, 64, jm.vocab, seed=4), positions(2, 64)
    tgt = tokens(2, 64, jm.vocab, seed=5)
    want = float(jtr.lm_loss(jm, params, tok, tgt, pos, fused_xent=fused,
                             xent_block=64))
    with torch.no_grad():
        got = ttr.lm_loss(tm, torch.from_numpy(tok), torch.from_numpy(tgt),
                          torch.from_numpy(pos), fused_xent=fused,
                          xent_block=64)
    assert abs(float(got) - want) <= atol


def test_lm_loss_auto_fuses_like_reference():
    # vocab 256 >= 2 * 64 picks the fused head in both packages, with its
    # bf16 matmul; the unfused f32 head gives a measurably different loss.
    jm, params, tm = lm_pair(jnp.bfloat16)
    tok, pos = tokens(2, 32, jm.vocab, seed=6), positions(2, 32)
    tgt = tokens(2, 32, jm.vocab, seed=7)
    args = [torch.from_numpy(a) for a in (tok, tgt, pos)]
    with torch.no_grad():
        auto = float(ttr.lm_loss(tm, *args, xent_block=64))
        fused = float(ttr.lm_loss(tm, *args, fused_xent=True,
                                  xent_block=64))
    assert auto == fused
    want = float(jtr.lm_loss(jm, params, tok, tgt, pos, xent_block=64))
    assert abs(auto - want) <= 1e-2


@pytest.mark.parametrize("block", [64, 100, 256])
@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-5),
                                        (jnp.bfloat16, 1e-4)])
def test_fused_xent_matches_reference(block, dtype, atol):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(48, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 256)) * 0.3).astype(np.float32)
    t = rng.integers(0, 256, 48).astype(np.int32)
    want = np.asarray(j_xent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(t),
                             block, dtype))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = t_xent(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(t), block, tdt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-5)


def test_loss_fn_matches_reference():
    rng = np.random.default_rng(12)
    lg = rng.normal(size=(2, 8, 32)).astype(np.float32)
    t = rng.integers(0, 32, (2, 8)).astype(np.int32)
    want = float(jtr.loss_fn(jnp.asarray(lg), jnp.asarray(t)))
    got = float(ttr.loss_fn(torch.from_numpy(lg), torch.from_numpy(t)))
    assert abs(got - want) <= 1e-6


def test_odd_length_runs_plain_attention():
    # S = 13 is not a multiple of 8: the block pads to 16 for attention
    # and cuts back, where the reference runs its plain attention
    # unpadded. Logits and the returned K/V heads agree.
    jm, params, tm = lm_pair()
    tok, pos = tokens(1, 13, jm.vocab, seed=8), positions(1, 13)
    want = np.asarray(jm.apply(params, tok, pos))
    _, inter = jm.clone(sow_kv=True).apply(params, tok, pos,
                                           mutable=("intermediates",))
    with torch.no_grad():
        got, kvs = tm(torch.from_numpy(tok), torch.from_numpy(pos),
                      return_kv=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for i, (k, v) in enumerate(kvs):
        (jk, jv), = inter["intermediates"][f"block{i}"]["kv"]
        assert k.shape == jk.shape == (1, jm.heads, 13, jm.dim // jm.heads)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)


def test_from_flax_rejects_mismatched_trees():
    jm, params, tm = lm_pair()
    tree = {"params": {k: v for k, v in params["params"].items()
                       if k != "block1"}}
    with pytest.raises(KeyError, match="block1"):
        weights.from_flax(tree, tm)
    other = ttr.TransformerLM(vocab=128, dim=64, heads=4, layers=2,
                              compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        weights.from_flax(params, other)


@pytest.mark.parametrize("kw", [dict(n_experts=2), dict(mesh=object()),
                                dict(remat=True)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError):
        ttr.TransformerLM(vocab=64, dim=32, heads=4, layers=1,
                          device="cpu", **kw)


def test_init_weights_is_seeded():
    def make(seed):
        m = ttr.TransformerLM(vocab=64, dim=32, heads=4, layers=1,
                              device="cpu")
        return m.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
        if pa.ndim == 2:
            assert not torch.equal(pa, pc), n
            fan_in = pa.shape[1]
            assert abs(float(pa.detach().std()) * fan_in ** 0.5 - 1) < 0.2, n
