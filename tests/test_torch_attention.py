"""Parity of the port's attention (``ddstore_tpu_torch.ops.attention``)
with the JAX reference's Pallas flash attention, which runs in interpret
mode on the CPU as ``tests/test_attention.py`` runs it.

On a CPU tensor ``flash_attention`` is the plain version, forward and
backward; these tests pin its arithmetic, its gradients (the plain dq and
dk/dv that the CUDA kernels are held against), its API (offsets,
fully-masked rows, the length and ``bwd_blocks`` checks and their error
text) and its refusals. The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
Tolerances: f32 atol 1e-5 (summation order only); bf16 gradients 2e-2 of
each row's L2 norm (both sides round p and ds to bf16 at 2**-8, but sum
in other orders, so a rounding may fall the other way)."""

import os

import jax
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


BF16_ROW_REL = 2e-2


def _vjp_both(q, k, v, do, dlse, dtype, **kw):
    """Gradients of (out, lse) with cotangents (do, dlse) through the JAX
    flash attention (interpret mode) and the port's, on the same inputs
    rounded to ``dtype``; returns ((jdq, jdk, jdv), (tdq, tdk, tdv), lse)
    as f32 numpy arrays."""
    jbwd = kw.pop("bwd_blocks", None)
    jkw = dict(kw, block_q=kw.pop("block_q", 64),
               block_k=kw.pop("block_k", 64), bwd_blocks=jbwd)
    (_, jl), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, **jkw),
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    dlse = np.where(np.isfinite(np.asarray(jl)), dlse, 0).astype(np.float32)
    want = vjp((jnp.asarray(do, dtype), jnp.asarray(dlse)))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    before = tatt.flash_bwd_dq_launches + tatt.flash_bwd_dkv_launches
    out, lse = tatt.flash_attention(*ts, bwd_blocks=jbwd, **kw)
    got = torch.autograd.grad((out, lse), ts, (
        torch.from_numpy(do).to(tdt), torch.from_numpy(dlse)))
    # the CPU runs the plain backward: no kernel launch is counted
    assert tatt.flash_bwd_dq_launches + tatt.flash_bwd_dkv_launches == before
    for g, t in zip(got, ts):
        assert g.dtype == t.dtype and g.shape == t.shape
    return ([np.asarray(a, np.float32) for a in want],
            [g.float().numpy() for g in got], lse.detach().numpy())


def _assert_grads_close(want, got, dtype):
    for name, w, g in zip(("dq", "dk", "dv"), want, got):
        assert not np.isnan(g).any(), name
        if dtype == np.float32:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                       err_msg=name)
            continue
        norm = np.linalg.norm(w, axis=-1)
        err = np.linalg.norm(g - w, axis=-1)
        assert (err <= BF16_ROW_REL * np.maximum(norm, 1e-3)).all(), \
            (name, float((err / np.maximum(norm, 1e-3)).max()))


def _cotangents(seed, q, with_lse=True):
    rng = np.random.default_rng(seed)
    do = rng.normal(size=q.shape).astype(np.float32)
    dlse = rng.normal(size=q.shape[:3]).astype(np.float32) if with_lse \
        else np.zeros(q.shape[:3], np.float32)
    return do, dlse


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal,s,d", [
    pytest.param(False, 128, 64, id="False"),
    pytest.param(True, 128, 64, id="True"),
    # the edges of the CUDA dq kernel's tiles: head dim 128 with a ragged
    # last 128-query block and 64-key tile; a 128-query block whose second
    # 64-row half holds 8 rows below Sq
    pytest.param(True, 200, 128, id="True-d128-s200"),
    pytest.param(True, 72, 64, id="True-s72")])
def test_flash_gradients_match_reference(causal, s, d, dtype):
    # tests/test_attention.py:85: lse in the loss, so dlse != 0
    q, k, v = _qkv(5, b=1, h=2, s=s, d=d)
    want, got, _ = _vjp_both(q, k, v, *_cotangents(9, q), dtype,
                             causal=causal)
    _assert_grads_close(want, got, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_blocks_gradients_match_reference(causal, dtype):
    # tests/test_attention.py:110: rectangular dq/dkv blocks unlike the
    # forward's, out only (dlse = 0)
    q, k, v = _qkv(6, b=1, h=2, s=256, d=64)
    want, got, _ = _vjp_both(q, k, v, *_cotangents(10, q, with_lse=False),
                             dtype, causal=causal, block_q=128, block_k=64,
                             bwd_blocks=(64, 128, 32, 256))
    _assert_grads_close(want, got, dtype)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("q_off,kv_off", [(128, 0), (0, 128), (64, 64),
                                          (0, 40)])
def test_offset_gradients_and_fully_masked_rows(q_off, kv_off, dtype):
    # tests/test_attention.py:35: offsets shift the causal frontier; rows
    # with no live key get dq 0, keys no query sees get dk = dv = 0
    q, k, v = _qkv(7, b=1, s=128)
    want, got, lse = _vjp_both(q, k, v, *_cotangents(11, q), dtype,
                               causal=True, q_offset=q_off,
                               kv_offset=kv_off)
    _assert_grads_close(want, got, dtype)
    dq, dk, dv = got
    dead_q = ~np.isfinite(lse)
    assert (dq[dead_q] == 0).all()
    if kv_off > q_off:
        assert dead_q.any()
        # key j is seen by no query iff kv_off + j > q_off + 127
        dead_k = kv_off + np.arange(128) > q_off + 127
        assert dead_k.any() == (kv_off - q_off > 0)
        assert (dk[:, :, dead_k] == 0).all() and \
            (dv[:, :, dead_k] == 0).all()


def test_cross_length_gradients_match_reference():
    q, k, v = _qkv(8, s=64, sk=192, d=32)
    want, got, _ = _vjp_both(q, k, v, *_cotangents(12, q), np.float32,
                             causal=True, kv_offset=-128, scale=0.3)
    _assert_grads_close(want, got, np.float32)


@pytest.mark.parametrize("bwd_blocks", [(4, 64, 64, 64), (64, 64, 64, 0),
                                        (64, -8, 32, 32)])
def test_bwd_blocks_refused_like_reference(bwd_blocks):
    q = np.zeros((1, 1, 64, 64), np.float32)
    with pytest.raises(ValueError) as jerr:
        jatt.flash_attention(*(jnp.asarray(q),) * 3, bwd_blocks=bwd_blocks)
    with pytest.raises(ValueError) as terr:
        tatt.flash_attention(*(torch.from_numpy(q),) * 3,
                             bwd_blocks=bwd_blocks)
    assert str(terr.value) == str(jerr.value)


def test_plain_backward_matches_autograd_of_plain_forward():
    # An oracle independent of the JAX package: autograd through the
    # plain forward gives the same dq, dk, dv as the plain backward.
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(4, s=64, sk=96))
    do, dlse = (torch.from_numpy(a) for a in _cotangents(13, q.detach()))
    kw = dict(causal=True, q_offset=32, kv_offset=0)
    got = torch.autograd.grad(tatt.flash_attention(q, k, v, **kw),
                              (q, k, v), (do, dlse))
    want = torch.autograd.grad(tatt.mha_reference(q, k, v, **kw),
                               (q, k, v), (do, dlse))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


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
    # A header beside the source (every source may include it) counts too.
    os.utime(lib, (src_t + 30, src_t + 30))
    assert not _build._stale("k")
    hdr = tmp_path / "sm90.cuh"
    hdr.write_text("// shared header\n")
    os.utime(hdr, (src_t + 25, src_t + 25))
    assert not _build._stale("k")
    os.utime(hdr, (src_t + 40, src_t + 40))
    assert _build._stale("k")


def _fused_views(b=2, h=3, s=16, d=64):
    """q, k, v as the transformer hands them over: (B, H, S, D) views of
    one (B, S, 3 * H * D) bf16 projection (row stride 3 * H * D)."""
    qkv = torch.randn((b, s, 3 * h * d)).to(torch.bfloat16)
    return [t.reshape(b, s, h, d).transpose(1, 2)
            for t in qkv.split(h * d, dim=-1)]


def _odd_row_stride():
    return torch.randn((2, 3, 16, 65)).to(torch.bfloat16)[..., :64]


def _base_off_by_one():
    flat = torch.randn(1 + 2 * 3 * 16 * 64).to(torch.bfloat16)
    return flat[1:].view(2, 3, 16, 64)


def _feature_stride():
    return torch.randn((2, 3, 64, 16)).to(torch.bfloat16).transpose(-1, -2)


@pytest.mark.parametrize("make,in_place", [
    (lambda: _fused_views()[0], True), (lambda: _fused_views()[1], True),
    (lambda: _fused_views()[2], True), (_odd_row_stride, False),
    (_base_off_by_one, False), (_feature_stride, False)],
    ids=["fused_q", "fused_k", "fused_v", "odd_row_stride",
         "base_off_by_one", "feature_stride"])
def test_aligned_meets_the_tensor_map_contract(make, in_place):
    # What a TMA tensor map takes: a 16-byte aligned base, a unit feature
    # stride and every other stride a multiple of 16 bytes. The fused
    # projection's views already meet it and pass uncopied; anything else
    # becomes a copy that meets it, with the same values.
    t = make()
    got = tatt._aligned(t)
    assert (got is t) == in_place
    assert got.data_ptr() % 16 == 0 and got.stride(-1) == 1
    assert all(s > 0 and s * got.element_size() % 16 == 0
               for s in got.stride()[:-1])
    assert torch.equal(got, t)
