"""Tests of the port's MoE and model-parallel layouts that need a CUDA
card: the MoE LM on the card against the same model on the CPU (plain
attention), and a small f32 LM placed over tp 2, ep 2 (MoE) and fsdp 2
by two rank processes on card 0 (gloo, NCCL takes one card per rank)
against one process's step on the CPU. Elsewhere they skip.

On the card (the repository's conftest imports jax, which that machine
need not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_layouts.py

Tolerances: the MoE LM in f32, logits 1e-4 and the loss 1e-5 (the
kernels' f32 tolerance, ``chip_smoke.py``'s small reference check), its
gradients 1e-4 of each leaf's largest; the layouts' losses 1e-5 relative
and the parameters after one Adam step (lr 1e-3) at rtol 5e-3, atol 5e-4,
as ``chip_smoke.py``'s small reference check holds a step on the card
(Adam divides by sqrt(nu), which amplifies summation-order noise in
near-zero gradients)."""

import numpy as np
import pytest
import torch

from ddstore_tpu_torch.models import decode
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.ops import attention

from torch_workers import layouts_cuda, spawn

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_on_card_matches_cpu(cuda, top_k):
    cfg = dict(vocab=512, dim=256, heads=4, layers=2, n_experts=4,
               moe_top_k=top_k, compute_dtype=torch.float32)
    cpu = ttr.TransformerLM(device="cpu", **cfg)
    cpu.init_weights(torch.Generator().manual_seed(2))
    card = ttr.TransformerLM(device=cuda, **cfg)
    card.load_state_dict(cpu.state_dict())
    g = np.random.default_rng(4)
    tok, tgt = (torch.from_numpy(g.integers(0, 512, (2, 128)))
                for _ in range(2))
    pos = torch.arange(128).expand(2, 128)
    before = attention.flash_fwd_launches
    with torch.no_grad():
        lg = card(tok.to(cuda), pos.to(cuda)).cpu()
    assert attention.flash_fwd_launches - before == cfg["layers"]
    with torch.no_grad():
        assert float((lg - cpu(tok, pos)).abs().max()) <= 1e-4
    lc = ttr.lm_loss(card, tok.to(cuda), tgt.to(cuda), pos.to(cuda))
    lp = ttr.lm_loss(cpu, tok, tgt, pos)
    assert abs(float(lc) - float(lp)) <= 1e-5
    lc.backward()
    lp.backward()
    for (n, a), b in zip(card.named_parameters(), cpu.parameters()):
        err = float((a.grad.cpu() - b.grad).abs().max())
        assert err <= 1e-4 * max(float(b.grad.abs().max()), 1e-30), n
    got = decode.generate(card, tok[:, :60].to(cuda), 8).cpu()
    assert torch.equal(got, decode.generate(cpu, tok[:, :60], 8))


@pytest.fixture(scope="module")
def layouts(cuda, tmp_path_factory):
    return spawn(2, layouts_cuda, str(tmp_path_factory.mktemp("layouts")),
                 timeout=400)


@pytest.mark.parametrize("name", ["tp2", "ep2", "fsdp2"])
def test_layout_step_on_card_matches_one_process(layouts, name):
    r0, r1 = layouts[0][name], layouts[1][name]
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - r0["cpu_loss"]) <= 1e-5 * abs(r0["cpu_loss"])
    assert r0["worst"] <= 5e-4, r0["worst"]
