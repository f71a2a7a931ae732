"""Tests of the port that need a CUDA card: the flash-attention kernel
against its plain version, the transformer block's use of it, and the
loader's staging onto the card. Elsewhere they skip.

On the card (the repository's conftest imports jax, which that machine
need not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: bf16 out 2e-2 and lse 1e-2, f32
1e-4."""

import numpy as np
import pytest
import torch

from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.ops import attention
from ddstore_tpu_torch.store import DDStore

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, (2e-2, 1e-2)),
                                       (torch.float32, (1e-4, 1e-4))])
@pytest.mark.parametrize("s,d,causal,q_off,kv_off",
                         [(256, 64, True, 0, 0), (200, 64, False, 0, 0),
                          (136, 128, True, 0, 0), (128, 64, True, 0, 64)])
def test_kernel_matches_plain(cuda, dtype, tol, s, d, causal, q_off,
                              kv_off):
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((2, 3, s, d), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    before = attention.flash_fwd_launches
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=causal,
                                             q_offset=q_off,
                                             kv_offset=kv_off)
        ref, ref_lse = attention.mha_reference(q, k, v, causal=causal,
                                               q_offset=q_off,
                                               kv_offset=kv_off)
    torch.cuda.synchronize()
    assert attention.flash_fwd_launches == before + 1
    live = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), live)
    assert not torch.isnan(out).any()
    assert (out.float() - ref.float()).abs().max() <= tol[0]
    assert (lse[live] - ref_lse[live]).abs().max() <= tol[1]
    assert (out[~live] == 0).all()


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        attention.flash_attention(q, q, q)


@pytest.mark.parametrize("s", [64, 100])
def test_block_uses_the_kernel(cuda, s):
    # S = 100 is not a multiple of 8: the block pads to 104 for the
    # kernel and cuts back; it never runs the plain version on the card.
    model = ttr.TransformerLM(vocab=128, dim=128, heads=2, layers=2,
                              compute_dtype=torch.float32, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(0))
    cpu = ttr.TransformerLM(vocab=128, dim=128, heads=2, layers=2,
                            compute_dtype=torch.float32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    tok = torch.randint(0, 128, (2, s), dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32).expand(2, s)
    before = attention.flash_fwd_launches
    with torch.no_grad():
        got, kvs = model(tok.to(cuda), pos.to(cuda), return_kv=True)
        want, want_kvs = cpu(tok, pos, return_kv=True)
    assert attention.flash_fwd_launches == before + 2
    assert (got.cpu() - want).abs().max() <= 1e-4
    for (k, v), (wk, wv) in zip(kvs, want_kvs):
        assert k.shape == wk.shape == (2, 2, s, 64)
        assert (k.cpu() - wk).abs().max() <= 1e-4
        assert (v.cpu() - wv).abs().max() <= 1e-4


def test_loader_stages_on_the_card(cuda):
    data = np.arange(40 * 8, dtype=np.int32).reshape(40, 8)
    with DDStore() as store:
        ds = ShardedDataset(store, data, data + 1)
        loader = DeviceLoader(ds, DistributedSampler(40, 1, 0, seed=1), 5,
                              device=cuda)
        seen = []
        for x, y in loader:
            assert x.is_cuda and y.is_cuda
            assert torch.equal(y, x + 1)
            seen.append(x[:, 0].cpu() // 8)
    order = torch.cat(seen).numpy()
    np.testing.assert_array_equal(
        order, DistributedSampler(40, 1, 0, seed=1).epoch_indices())
    assert loader.metrics.stage.count == 8
