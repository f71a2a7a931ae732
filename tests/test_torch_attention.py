"""Parity of the port's attention (``ddstore_tpu_torch.ops.attention``)
with the JAX reference's Pallas flash attention, which runs in interpret
mode on the CPU as ``tests/test_attention.py`` runs it.

On a CPU tensor ``flash_attention`` is the plain version; these tests pin
its arithmetic, its API (offsets, fully-masked rows, the length check
and its error text) and its refusals. The CUDA kernel is held against
the same plain version on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``. Tolerance: f32 atol 1e-5 (summation order
only)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.ops import attention as jatt
from ddstore_tpu_torch.ops import _build
from ddstore_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.tier1_required

ATOL = 1e-5


def _qkv(seed, b=2, h=2, s=128, d=64, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


def _both(q, k, v, **kw):
    jo, jl = jatt.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  block_q=64, block_k=64, **kw)
    to, tl = tatt.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  **kw)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


def _assert_close(want, got):
    (jo, jl), (to, tl) = want, got
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), fin)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=ATOL, rtol=0)
    assert not np.isnan(to).any()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_reference(causal):
    q, k, v = _qkv(0)
    _assert_close(*_both(q, k, v, causal=causal))


@pytest.mark.parametrize("q_off,kv_off", [(128, 0), (0, 128), (64, 64),
                                          (0, 40)])
def test_offsets_and_fully_masked_rows(q_off, kv_off):
    q, k, v = _qkv(1, b=1)
    want, got = _both(q, k, v, causal=True, q_offset=q_off,
                      kv_offset=kv_off)
    _assert_close(want, got)
    dead = ~np.isfinite(got[1])
    if kv_off > q_off:  # rows before the first key are fully masked
        assert dead.any()
    assert (got[0][dead] == 0).all()
    assert (got[1][dead] == -np.inf).all()


def test_cross_lengths_and_scale():
    q, k, v = _qkv(2, s=64, sk=192, d=32)
    _assert_close(*_both(q, k, v, causal=True, kv_offset=-128, scale=0.3))


def test_mha_reference_matches_reference_bf16():
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(3, s=64))
    jo, jl = jatt.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=True)
    to, tl = tatt.mha_reference(
        *(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
          for a in (q, k, v)), causal=True)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    # out rounds to bf16 in both: one bf16 ulp at |out| < 4 is 1.6e-2
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), atol=1.6e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("sq,sk", [(100, 128), (128, 36), (7, 7)])
def test_lengths_not_multiple_of_8_raise_like_reference(sq, sk):
    q = np.zeros((1, 1, sq, 64), np.float32)
    k = np.zeros((1, 1, sk, 64), np.float32)
    with pytest.raises(ValueError) as jerr:
        jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k))
    with pytest.raises(ValueError) as terr:
        tatt.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("block,s,want", [(512, 640, 320), (64, 128, 64),
                                          (512, 100, 0), (2048, 8, 8)])
def test_fit_block_matches_reference(block, s, want):
    assert tatt._fit_block(block, s) == jatt._fit_block(block, s) == want


def test_grad_raises_until_backward_is_ported():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, s=16))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="flash backward"):
        tatt.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        out, _ = tatt.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape


def test_non_cpu_tensor_never_takes_the_plain_path():
    # A tensor off the CPU goes to the kernel wrapper, which launches or
    # raises: here (no card) it raises, and the plain version is not run.
    q = torch.empty((1, 1, 16, 64), device="meta")
    before = tatt.flash_fwd_launches
    with pytest.raises(ValueError, match="kernel runs on CUDA"):
        tatt.flash_attention(q, q, q, causal=True)
    assert tatt.flash_fwd_launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not list(tmp_path.glob("*.so"))


def test_build_staleness(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    assert _build._stale("k")
    lib = _build._lib_path("k")
    lib.parent.mkdir()
    lib.write_bytes(b"")
    src_t = src.stat().st_mtime
    os.utime(lib, (src_t + 10, src_t + 10))
    assert not _build._stale("k")
    os.utime(src, (src_t + 20, src_t + 20))
    assert _build._stale("k")
