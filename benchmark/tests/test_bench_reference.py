"""The plain reference agrees with the port's plain CPU path at a tiny
width in float32 (this test imports both; the reference imports nothing
of the port), and leaves torch's TF32 flags as it found them."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import corpus, reference, weights

from conftest import TINY_MODEL

SEED = 2147483771
LR = 3e-4


def _port(model_cfg):
    from ddstore_tpu_torch.models import transformer as tr
    m = model_cfg
    model = tr.TransformerLM(vocab=m["vocab"], dim=m["dim"], heads=m["heads"],
                             layers=m["layers"], mlp_ratio=m["mlp_ratio"],
                             compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(weights.make(m, SEED, "cpu"))
    return model


def _batches(m, steps=3, rows=4, seq=32):
    order = corpus.order(SEED, 4096, "random")
    return [corpus.windows(
        SEED, torch.as_tensor(order[k * rows:(k + 1) * rows]), seq,
        m["vocab"]) for k in range(steps)]


def _loss(P, m, tok, tgt, prec="f32") -> float:
    """The reference's mean token loss of one batch."""
    with torch.no_grad(), reference.exact_matmuls():
        return float(reference.nll(P, m, tok, tgt, prec).double().mean())


@pytest.mark.parametrize("fused", [False, True])
def test_loss_matches_the_port_in_float32(fused):
    from ddstore_tpu_torch.models import transformer as tr
    m = dict(TINY_MODEL, vocab=4096)  # two fused-head blocks at 2048
    tok, tgt = _batches(m, 1)[0]
    pos = torch.arange(tok.shape[1], dtype=torch.int32).expand_as(tok)
    with torch.no_grad():
        got = float(tr.lm_loss(_port(m), tok, tgt, pos, fused_xent=fused,
                               xent_block=2048))
    want = _loss(weights.make(m, SEED, "cpu"), m, tok, tgt)
    assert got == pytest.approx(want, rel=2e-6)


def test_adam_steps_match_the_port_in_float32():
    from ddstore_tpu_torch.models import transformer as tr
    m = TINY_MODEL
    batches = _batches(m)
    model = _port(m)
    state, opt = tr.create_train_state(model, lr=LR)
    step = tr.make_train_step(model, opt, state=state)
    pos = torch.arange(32, dtype=torch.int32).expand(4, 32)
    losses, grad1 = [], {}
    for i, (tok, tgt) in enumerate(batches):
        losses.append(float(step(tok, tgt, pos)))
        if i == 0:
            grad1 = {k: float(torch.linalg.vector_norm(
                opt.state[p]["exp_avg"], dtype=torch.float64)) / 0.1
                for k, p in model.named_parameters()}
    p0 = weights.make(m, SEED, "cpu")
    change = {k: float(torch.linalg.vector_norm(p.detach() - p0[k],
                                                dtype=torch.float64))
              for k, p in model.named_parameters()}
    ref_losses, ref_grad1, ref_change = reference.train(
        m, lambda: weights.make(m, SEED, "cpu"), batches, LR, 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-6)
    assert reference.worst_leaf_gap(grad1, ref_grad1)[0] < 1e-4
    keep = reference.moving_leaves(ref_grad1)
    assert reference.worst_leaf_gap(change, ref_change, keep)[0] < 1e-3


def test_the_fp8_control_departs_from_float32():
    m = TINY_MODEL
    tok, tgt = _batches(m, 1)[0]
    P = weights.make(m, SEED, "cpu")
    f32 = _loss(P, m, tok, tgt)
    fp8 = _loss(P, m, tok, tgt, "fp8")
    assert 1e-6 < abs(fp8 - f32) / f32 < 1e-1


def test_tf32_flags_are_restored():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = False
        before = (True, False)
        m = TINY_MODEL
        tok, tgt = _batches(m, 1)[0]
        with reference.exact_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        reference.train(m, lambda: weights.make(m, SEED, "cpu"),
                        [(tok, tgt)], LR, 2)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
