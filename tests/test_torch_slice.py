"""The port's slices end to end against the JAX package's, on the CPU:
token windows in the store -> sampler -> loader -> eval loss -> greedy
generate, and the same windows -> Adam train steps, through both packages
on the same data and the same weights.

Losses agree at atol 1e-5 (f32, summation order only); generated tokens
agree exactly; parameters after the training epoch at rtol 5e-3, atol
5e-4 (Adam amplifies summation-order noise in near-zero gradients, see
``tests/test_decode.py:134``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import optax

import ddstore_tpu as ref
from ddstore_tpu.data import dataset as rds
from ddstore_tpu.data import loader as rld
from ddstore_tpu.models import decode as jdec
from ddstore_tpu.models import transformer as jtr
from ddstore_tpu_torch import store as tstore
from ddstore_tpu_torch import weights
from ddstore_tpu_torch.data import dataset as tds
from ddstore_tpu_torch.data import loader as tld
from ddstore_tpu_torch.models import decode as tdec
from ddstore_tpu_torch.models import transformer as ttr

from torch_parity import flat_leaves, lm_pair

pytestmark = pytest.mark.tier1_required

WINDOWS, SEQ, BATCH = 24, 64, 4


def _corpus(vocab, seed=0):
    """Windows and next-token targets of a repeated-pattern corpus, built
    as ``examples/lm_longcontext.py`` builds it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=64)
    corpus = np.tile(base, WINDOWS * SEQ // 64 + 2)
    starts = rng.integers(0, len(corpus) - SEQ - 1, size=WINDOWS)
    win = np.stack([corpus[s:s + SEQ] for s in starts]).astype(np.int32)
    nxt = np.stack([corpus[s + 1:s + SEQ + 1] for s in starts]
                   ).astype(np.int32)
    return win, nxt


@pytest.mark.parametrize("fused", [False, True])
def test_slice_matches_reference(fused):
    jm, params, tm = lm_pair()
    win, nxt = _corpus(jm.vocab)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (BATCH, 1))

    rs = ref.DDStore(ref.SingleGroup(), backend="local")
    rl = rld.DeviceLoader(rds.ShardedDataset(rs, win, nxt),
                          rds.DistributedSampler(WINDOWS, 1, 0, seed=5),
                          BATCH, mesh=None)
    want_loss, prompts = [], None
    for tok, tgt in rl:
        want_loss.append(float(jtr.lm_loss(jm, params, tok, tgt, pos,
                                           fused_xent=fused,
                                           xent_block=64)))
        prompts = tok
    want_gen = np.asarray(jdec.generate(jm, params, jnp.asarray(prompts), 5))
    rs.close()

    with tstore.DDStore() as ts:
        tl = tld.DeviceLoader(tds.ShardedDataset(ts, win, nxt),
                              tds.DistributedSampler(WINDOWS, 1, 0, seed=5),
                              BATCH, device="cpu")
        tpos = torch.from_numpy(pos)
        got_loss, tprompts = [], None
        for tok, tgt in tl:
            with torch.no_grad():
                got_loss.append(float(ttr.lm_loss(tm, tok, tgt, tpos,
                                                  fused_xent=fused,
                                                  xent_block=64)))
            tprompts = tok
        got_gen = tdec.generate(tm, tprompts, 5)

    assert len(got_loss) == len(want_loss) == WINDOWS // BATCH
    np.testing.assert_allclose(got_loss, want_loss, atol=1e-5, rtol=0)
    assert all(np.isfinite(got_loss))
    np.testing.assert_array_equal(tprompts.numpy(), prompts)
    np.testing.assert_array_equal(got_gen.numpy(), want_gen)
    assert 0.0 <= tl.metrics.efficiency <= 1.0


@pytest.mark.parametrize("fused", [False, True])
def test_store_fed_training_matches_reference(fused):
    # The train step fed by the store, as examples/lm_longcontext.py runs
    # it: one epoch of 6 batches, losses compared step by step.
    jm, params, tm = lm_pair()
    win, nxt = _corpus(jm.vocab, seed=1)
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (BATCH, 1))

    tx = optax.adam(1e-2)
    jstate = jtr.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jstep = jtr.make_train_step(jm, tx, donate=False, fused_xent=fused)
    rs = ref.DDStore(ref.SingleGroup(), backend="local")
    rl = rld.DeviceLoader(rds.ShardedDataset(rs, win, nxt),
                          rds.DistributedSampler(WINDOWS, 1, 0, seed=7),
                          BATCH, mesh=None)
    want = []
    for tok, tgt in rl:
        jstate, loss = jstep(jstate, tok, tgt, pos)
        want.append(float(loss))
    rs.close()

    state, opt = ttr.create_train_state(tm, lr=1e-2)
    step = ttr.make_train_step(tm, opt, fused_xent=fused, state=state)
    with tstore.DDStore() as ts:
        tl = tld.DeviceLoader(tds.ShardedDataset(ts, win, nxt),
                              tds.DistributedSampler(WINDOWS, 1, 0, seed=7),
                              BATCH, device="cpu")
        got = [float(step(tok, tgt, torch.from_numpy(pos)))
               for tok, tgt in tl]

    assert len(got) == len(want) == WINDOWS // BATCH == state.step
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]  # the corpus repeats a 64-token pattern
    got = flat_leaves(weights.to_flax(tm))
    want = flat_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    for key, ref_leaf in want.items():
        np.testing.assert_allclose(got[key], ref_leaf, rtol=5e-3,
                                   atol=5e-4, err_msg=key)
