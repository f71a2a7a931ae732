"""Parity of the port's KV-cached decoding with the JAX reference
(``ddstore_tpu/models/decode.py``), on the CPU at f32.

Greedy tokens must equal the reference's exactly; teacher-forced step
logits must equal the full forward at every position (atol 2e-4, as
``tests/test_decode.py:33`` pins the reference)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.models import decode as jdec
from ddstore_tpu_torch.models import decode as tdec

from torch_parity import lm_pair, positions, tokens

pytestmark = pytest.mark.tier1_required


def test_decode_step_matches_full_forward():
    jm, params, tm = lm_pair()
    b, s = 2, 12
    tok = torch.from_numpy(tokens(b, s, jm.vocab, seed=1))
    with torch.no_grad():
        full = tm(tok, torch.from_numpy(positions(b, s)))
    cache = tdec.init_cache(tm, b, s)
    assert cache["k"].shape == (2, b, 4, s, 16)
    for t in range(s):
        logits, cache = tdec.decode_step(tm, cache, t, tok[:, t:t + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"position {t}")


def test_decode_step_matches_reference_step():
    jm, params, tm = lm_pair()
    b, s = 2, 6
    tok = tokens(b, s, jm.vocab, seed=2)
    jc = jdec.init_cache(jm, b, s)
    tc = tdec.init_cache(tm, b, s)
    for t in range(s):
        jl, jc = jdec.decode_step(jm, params, jc, t, tok[:, t:t + 1])
        tl, tc = tdec.decode_step(tm, tc, t, torch.from_numpy(
            tok[:, t:t + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=1e-5)


def test_decode_step_rejects_slot_outside_cache():
    jm, params, tm = lm_pair()
    cache = tdec.init_cache(tm, 1, 4)
    with pytest.raises(ValueError, match="outside cache"):
        tdec.decode_step(tm, cache, 4, torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("plen,new", [(5, 6), (16, 4)])
def test_generate_greedy_matches_reference(plen, new):
    jm, params, tm = lm_pair()
    prompt = tokens(2, plen, jm.vocab, seed=3)
    want = np.asarray(jdec.generate(jm, params, jnp.asarray(prompt), new))
    got = tdec.generate(tm, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and got.shape == (2, plen + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_padded_batch_matches_reference():
    jm, params, tm = lm_pair()
    lengths = np.array([3, 5, 2], np.int32)
    prompt = tokens(3, 5, jm.vocab, seed=4)
    prompt[np.arange(5)[None, :] >= lengths[:, None]] = jm.vocab - 1
    want = np.asarray(jdec.generate(jm, params, jnp.asarray(prompt), 6,
                                    prompt_lengths=jnp.asarray(lengths)))
    got = tdec.generate(tm, torch.from_numpy(prompt), 6,
                        prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    # and each row equals that row generated alone at its own length
    for i, n in enumerate(lengths):
        alone = tdec.generate(tm, torch.from_numpy(prompt[i:i + 1, :n]), 6)
        np.testing.assert_array_equal(got[i, 5:].numpy(),
                                      alone[0, n:].numpy())


@pytest.mark.parametrize("lengths", [[4], [0, 4], [4, 5]])
def test_generate_rejects_bad_lengths(lengths):
    jm, params, tm = lm_pair()
    with pytest.raises(ValueError):
        tdec.generate(tm, torch.zeros((2, 4), dtype=torch.int32), 2,
                      prompt_lengths=torch.tensor(lengths))


def test_generate_sampling_is_seeded_and_top_k1_is_greedy():
    jm, params, tm = lm_pair()
    prompt = torch.from_numpy(tokens(2, 4, jm.vocab, seed=5))

    def sample(seed, **kw):
        return tdec.generate(tm, prompt, 6, temperature=1.0,
                             generator=torch.Generator().manual_seed(seed),
                             **kw)

    a, b = sample(7), sample(7)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < jm.vocab)).all()
    greedy = tdec.generate(tm, prompt, 6)
    assert torch.equal(sample(8, top_k=1), greedy)
    with pytest.raises(ValueError, match="generator"):
        tdec.generate(tm, prompt, 2, temperature=1.0)


def test_generate_stats_and_zero_new_tokens():
    jm, params, tm = lm_pair()
    prompt = torch.from_numpy(tokens(1, 8, jm.vocab, seed=6))
    stats = {}
    out = tdec.generate(tm, prompt, 3, stats=stats)
    assert out.shape == (1, 11) and stats["decode_steps"] == 2
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert tdec.generate(tm, prompt, 0) is prompt


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.5),
                                         (None, 0.9), (8, 0.7),
                                         (None, 1.0), (1, None)])
def test_filter_logits_matches_reference(top_k, top_p):
    lg = np.random.default_rng(9).normal(size=(4, 64)).astype(np.float32) * 2
    want = np.asarray(jdec.filter_logits(jnp.asarray(lg), top_k, top_p))
    got = tdec.filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


@pytest.mark.parametrize("kw", [dict(top_k=0), dict(top_p=0.0),
                                dict(top_p=1.5)])
def test_filter_logits_validates(kw):
    lg = torch.zeros((1, 4))
    with pytest.raises(ValueError):
        tdec.filter_logits(lg, **kw)
    with pytest.raises(ValueError):
        jdec.filter_logits(jnp.zeros((1, 4)), **kw)


def test_generate_bf16_runs():
    jm, params, tm = lm_pair(jnp.bfloat16)
    prompt = tokens(2, 8, jm.vocab, seed=10)
    got = tdec.generate(tm, torch.from_numpy(prompt), 4)
    assert got.shape == (2, 12)
    np.testing.assert_array_equal(got[:, :8].numpy(), prompt)
    assert ((got >= 0) & (got < jm.vocab)).all()
