"""Parity of the port's training path with the JAX reference, on the CPU
at a small size: the fused cross-entropy's gradients, ``lm_loss``'s
gradients leaf by leaf (by flax path, through ``weights.to_flax``), the
Adam train step, gradient accumulation, and the weight round trip.

Tolerances: gradients rtol 1e-4, atol 1e-6 in f32 (summation order
only); losses atol 1e-5; parameters after Adam rtol 5e-3, atol 5e-4, as
``tests/test_decode.py:134`` holds the reference's own: Adam divides by
sqrt(nu), which amplifies f32 summation-order noise in near-zero
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddstore_tpu.models import transformer as jtr
from ddstore_tpu.ops.xent import fused_linear_xent as j_xent
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.ops.xent import fused_linear_xent as t_xent

from torch_parity import flat_leaves, lm_pair, positions, tokens

pytestmark = pytest.mark.tier1_required

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ADAM_TOL = dict(rtol=5e-3, atol=5e-4)


def _assert_trees_close(got, want, **tol):
    got, want = flat_leaves(got), flat_leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=path, **tol)


def _grads(model):
    return weights.to_flax({n: p.grad for n, p in model.named_parameters()})


def _batch(vocab, b=4, s=16, seed=20):
    return (tokens(b, s, vocab, seed=seed), tokens(b, s, vocab, seed=seed + 1),
            positions(b, s))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("v,block", [(64, 16), (100, 32), (256, 256)])
def test_fused_xent_gradients_match_reference(v, block, dtype):
    # tests/test_xent.py:38's cases (100 is not a multiple of 32), with a
    # per-token cotangent so that every row is weighted differently
    rng = np.random.default_rng(v)
    n, d = 17, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    g = rng.uniform(0.5, 1.5, n).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: j_xent(x, w, jnp.asarray(t), block, dtype),
                     jnp.asarray(x), jnp.asarray(w))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    nll = t_xent(tx, tw, torch.from_numpy(t), block, tdt)
    got = torch.autograd.grad(nll, (tx, tw), torch.from_numpy(g))
    for name, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == torch.float32
        # bf16 operands: both round the same operands and dlogits to bf16
        np.testing.assert_allclose(a.numpy(), b, err_msg=name,
                                   **(GRAD_TOL if dtype == jnp.float32
                                      else dict(rtol=1e-3, atol=1e-5)))


def test_fused_xent_grad_dtypes_follow_inputs():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(9, 8)).astype(np.float32)) \
        .bfloat16().requires_grad_()
    w = torch.from_numpy(rng.normal(size=(8, 40)).astype(np.float32)) \
        .requires_grad_()
    t = torch.from_numpy(rng.integers(0, 40, 9))
    t_xent(x, w, t, 16).mean().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


@pytest.mark.parametrize("fused", [False, True])
def test_lm_loss_gradients_match_reference(fused):
    jm, params, tm = lm_pair()
    tok, tgt, pos = _batch(jm.vocab)
    loss, jg = jax.value_and_grad(
        lambda p: jtr.lm_loss(jm, p, tok, tgt, pos, fused_xent=fused,
                              xent_block=64))(params)
    got = ttr.lm_loss(tm, *(torch.from_numpy(a) for a in (tok, tgt, pos)),
                      fused_xent=fused, xent_block=64)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5
    _assert_trees_close(_grads(tm), jax.tree_util.tree_map(np.asarray, jg),
                        **GRAD_TOL)


def test_lm_loss_gradients_at_odd_length():
    # S = 13 pads to 16 for attention and is cut back: the gradient of the
    # cut flows back through the pad; the reference runs plain attention
    # unpadded.
    jm, params, tm = lm_pair()
    tok, tgt, pos = _batch(jm.vocab, b=2, s=13, seed=30)
    jg = jax.grad(lambda p: jtr.lm_loss(jm, p, tok, tgt, pos,
                                        fused_xent=False))(params)
    ttr.lm_loss(tm, *(torch.from_numpy(a) for a in (tok, tgt, pos)),
                fused_xent=False).backward()
    _assert_trees_close(_grads(tm), jax.tree_util.tree_map(np.asarray, jg),
                        **GRAD_TOL)


def _jax_state(params, lr):
    tx = optax.adam(lr)
    return jtr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)), tx


@pytest.mark.parametrize("fused", [False, True])
def test_three_train_steps_match_reference(fused):
    jm, params, tm = lm_pair()
    jstate, tx = _jax_state(params, 1e-2)
    jstep = jtr.make_train_step(jm, tx, donate=False, fused_xent=fused)
    state, opt = ttr.create_train_state(tm, lr=1e-2)
    step = ttr.make_train_step(tm, opt, fused_xent=fused, state=state)
    for i in range(3):
        tok, tgt, pos = _batch(jm.vocab, seed=40 + 2 * i)
        jstate, jl = jstep(jstate, tok, tgt, pos)
        loss = step(*(torch.from_numpy(a) for a in (tok, tgt, pos)))
        assert loss.dtype == torch.float32 and not loss.requires_grad
        assert abs(float(loss) - float(jl)) <= 1e-5, i
    assert state.step == 3 == int(jstate.step)
    _assert_trees_close(weights.to_flax(tm),
                        jax.tree_util.tree_map(np.asarray, jstate.params),
                        **ADAM_TOL)


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_big_batch_and_reference(accum):
    # tests/test_decode.py:118: equal chunks of a token-mean loss give the
    # big-batch gradients, so one accumulated step is the big-batch step
    jm, params, tm = lm_pair(vocab=48)
    tok, tgt, pos = _batch(48, b=8, seed=50)
    args = [torch.from_numpy(a) for a in (tok, tgt, pos)]
    base = {n: p.detach().clone() for n, p in tm.named_parameters()}

    _, opt1 = ttr.create_train_state(tm, lr=1e-2)
    l1 = ttr.make_train_step(tm, opt1, fused_xent=False)(*args)
    g1 = _grads(tm)
    p1 = weights.to_flax(tm)
    tm.load_state_dict(base)
    _, opt = ttr.create_train_state(tm, lr=1e-2)
    la = ttr.make_train_step(tm, opt, fused_xent=False,
                             accum_steps=accum)(*args)
    assert abs(float(l1) - float(la)) <= 1e-5
    _assert_trees_close(_grads(tm), g1, **GRAD_TOL)
    _assert_trees_close(weights.to_flax(tm), p1, **ADAM_TOL)

    jstate, tx = _jax_state(params, 1e-2)
    jstate, jl = jtr.make_train_step(jm, tx, donate=False, fused_xent=False,
                                     accum_steps=accum)(jstate, tok, tgt,
                                                        pos)
    assert abs(float(la) - float(jl)) <= 1e-5
    _assert_trees_close(weights.to_flax(tm),
                        jax.tree_util.tree_map(np.asarray, jstate.params),
                        **ADAM_TOL)


def test_indivisible_accum_raises_like_reference():
    jm, params, tm = lm_pair()
    tok, tgt, pos = _batch(jm.vocab, b=6)
    jstate, tx = _jax_state(params, 1e-3)
    with pytest.raises(ValueError, match="divisible") as jerr:
        jtr.make_train_step(jm, tx, donate=False, accum_steps=4)(
            jstate, tok, tgt, pos)
    _, opt = ttr.create_train_state(tm)
    before = weights.to_flax(tm)
    with pytest.raises(ValueError, match="divisible") as terr:
        ttr.make_train_step(tm, opt, accum_steps=4)(
            *(torch.from_numpy(a) for a in (tok, tgt, pos)))
    assert str(terr.value) == str(jerr.value)
    _assert_trees_close(weights.to_flax(tm), before, rtol=0, atol=0)


def test_adam_matches_optax_defaults():
    _, opt = ttr.create_train_state(
        ttr.TransformerLM(vocab=32, dim=32, heads=4, layers=1, device="cpu"),
        lr=1e-3)
    (group,) = opt.param_groups
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0.0
    assert not group["amsgrad"]


def test_to_flax_round_trips_exactly():
    _, params, tm = lm_pair()
    want = jax.tree_util.tree_map(np.asarray, params)
    got = weights.to_flax(weights.from_flax(want, tm))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    _assert_trees_close(got, want, rtol=0, atol=0)
