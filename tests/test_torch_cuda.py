"""Tests of the port that need a CUDA card: the flash-attention kernels
(forward, dq, dk/dv) against their plain versions, at every head dim and
at a batch, heads or tile count past 65,535 (grid y's and z's cap), the
transformer block's use of them, the loader's staging onto the card (with and
without readahead, and of a ``GraphBatch``), a VAE step and an MPNN step
on the card against the CPU step, a restored train state placed as the
saved one, a two-process store-fed DDP VAE on one card, and the device-collective fetch and loader epoch in a one-process
NCCL group (byte-equal to the host path, the exchange on the card).
Elsewhere they skip.

On the card (the repository's conftest imports jax, which that machine
need not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: bf16 out 2e-2 and lse 1e-2, fp16
4e-3 and 2e-3, f32 1e-4; gradients 2e-2 of each row's L2 norm in bf16 (p
and ds round to bf16 at 2**-8), 4e-3 in fp16 (2**-11: a fifth of bf16's,
which leaves room for the summation order), 1e-4 in f32. The MPNN step
as ``chip_smoke.py``'s (``GNN_F32_TOL`` and ``GNN_BF16_FACTOR``, which
give the reasons): in
f32 each gradient leaf's L2 error over its L2 norm 1e-4, the parameters
after one Adam step at lr 1e-3 1e-4; in bf16 the card's and the CPU's
steps against the CPU's f32 step, the card's error at most 3x the
CPU's."""

import numpy as np
import pytest
import torch

from ddstore_tpu_torch.data import graphs
from ddstore_tpu_torch.data.dataset import DistributedSampler, ShardedDataset
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.models import gnn
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.models import vae
from ddstore_tpu_torch.ops import attention
from ddstore_tpu_torch.store import DDStore

pytestmark = pytest.mark.gpu

# head dims other than 64 and 128: below, inside and above the 64 and 128
# tiles, not a multiple of 8 (20), inside the 256 tile (136, 160, 200,
# 248: the three kernels' TMA + wgmma tile zero-filled past d) and its
# edge
HEAD_DIMS = (8, 16, 20, 32, 40, 96, 136, 160, 200, 248, 256)
# past 256: two to four chunks of 256 features, the last one partly
# zero-filled (264, 320, 1000) and not a multiple of 8 (300, 1000)
WIDE_DIMS = (264, 300, 320, 512, 1000, 1024)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, (2e-2, 1e-2)),
                                       (torch.float32, (1e-4, 1e-4)),
                                       (torch.float16, (4e-3, 2e-3))])
@pytest.mark.parametrize("s,d,causal,q_off,kv_off",
                         [(256, 64, True, 0, 0), (200, 64, False, 0, 0),
                          (136, 128, True, 0, 0), (128, 64, True, 0, 64),
                          (40, 64, True, 0, 0), (200, 128, True, 0, 0)]
                         # every tile width, zero-filled past d, and head
                         # dims padded to a multiple of 8 (20)
                         + [(200, d, True, 0, 0) for d in HEAD_DIMS]
                         + [(136, d, False, 0, 0) for d in HEAD_DIMS]
                         + [(256, d, True, 192, 64) for d in HEAD_DIMS]
                         # chunks of 256 features
                         + [(200, d, True, 0, 0) for d in WIDE_DIMS]
                         + [(136, d, False, 0, 0) for d in WIDE_DIMS]
                         + [(256, d, True, 192, 64) for d in WIDE_DIMS]
                         # the f32 forward's tiles (128 query rows a block,
                         # 64 keys a tile, 32 past 128, features in chunks
                         # of 32, O in blocks of 256 columns past 128): a
                         # ragged last key tile (200), queries fewer than
                         # one 64-row warpgroup (40), a partial last
                         # feature chunk (72), a second block of columns
                         # (264)
                         + [(200, 72, True, 0, 0), (40, 72, True, 0, 0),
                            (256, 72, True, 192, 64), (40, 264, True, 0, 0)])
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


def _rows_close(got, want, dead, rel):
    """Largest error of a row (L2 over the head dim) relative to the plain
    version's row, or to a thousandth of its largest row where the row is
    smaller (such a row is the difference of two rounded sums); rows no
    live pair reaches (``dead``) must be exactly 0."""
    got, want = got.float(), want.float()
    assert (got[dead] == 0).all()
    norm = want.norm(dim=-1)
    err = (got - want).norm(dim=-1)[~dead] / \
        norm[~dead].clamp_min(1e-3 * float(norm.max()))
    assert err.numel() == 0 or float(err.max()) <= rel, float(err.max())


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4),
                                       (torch.float16, 4e-3)])
@pytest.mark.parametrize("sq,sk,d,causal,q_off,kv_off",
                         [(256, 256, 64, True, 0, 0),
                          (200, 200, 64, False, 0, 0),
                          (136, 136, 128, True, 0, 0),
                          (128, 128, 64, True, 0, 64),
                          (136, 520, 64, True, 384, 0),
                          (40, 40, 64, True, 0, 0),
                          (200, 200, 128, True, 0, 0),
                          # one 128-row dq block whose second warpgroup
                          # holds 8 rows below Sq and 56 past it
                          (72, 72, 64, True, 0, 0),
                          (72, 136, 128, False, 0, 0)]
                         + [(200, 200, d, True, 0, 0) for d in HEAD_DIMS]
                         + [(256, 256, d, True, 192, 64) for d in HEAD_DIMS]
                         + [(72, 136, d, False, 0, 0)
                            for d in (20, 136, 160, 200, 248)]
                         + [(200, 200, d, True, 0, 0) for d in WIDE_DIMS]
                         + [(256, 256, d, True, 192, 64) for d in WIDE_DIMS]
                         + [(72, 136, d, False, 0, 0) for d in (300, 512)]
                         # the f32 kernels' TF32 tiles (64 queries a dq
                         # block whose warpgroups split each 64-key tile,
                         # 64 keys a dk/dv block, query tiles of 64 (32
                         # past 128), features in chunks of 32, dQ, dK and
                         # dV in blocks of 256 columns): a ragged last key
                         # tile whose second warpgroup's 32 keys all lie
                         # past Sk, and ragged query tiles of 8 rows
                         + [(200, 72, d, True, 0, 0) for d in (8, 72)]
                         # a dq block whose second warpgroup's keys are all
                         # past Sk in every tile (Sk 24), non-causal
                         + [(136, 24, d, False, 0, 0) for d in (72, 136)]
                         # offsets: the causal frontier inside a 64-key
                         # tile of both kernels
                         + [(256, 256, d, True, 192, 64) for d in (72, 264)]
                         # fully-masked rows (kv_offset ahead by 40: the
                         # first 40 queries see no key) and keys no query
                         # sees, over a partial last feature chunk (72)
                         # and a second block of dQ's columns (264)
                         + [(128, 128, d, True, 0, 40)
                            for d in (8, 72, 136, 264)]
                         # the 16-bit dk/dv past 256 (64 keys and a chunk
                         # of 256 columns a block, query tiles of 64 and
                         # their chunk pairs streamed): the causal frontier
                         # inside a block with a ragged last key tile, and
                         # fully-masked rows beside keys no query sees
                         + [(136, 200, d, True, 64, 0) for d in (264, 300)]
                         + [(200, 136, d, True, 0, 40) for d in (264, 300)]
                         # the 16-bit dq past 256 (64 queries and a chunk of
                         # 256 columns a block, 64-key tiles and their chunk
                         # pairs streamed): three chunks, the last partial
                         # (520); the causal frontier inside a 64-query
                         # block (1024); Sk not a multiple of 64; fully-
                         # masked rows beside keys no query sees
                         + [(200, 200, 520, True, 0, 0),
                            (136, 136, 520, False, 0, 0),
                            (128, 128, 1024, True, 32, 0),
                            (128, 200, 512, False, 0, 0),
                            (72, 136, 1024, True, 64, 0),
                            (128, 128, 520, True, 0, 40)])
def test_backward_kernels_match_plain(cuda, dtype, rel, sq, sk, d, causal,
                                      q_off, kv_off):
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((2, 3, sq, d), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, 3, sk, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((2, 3, sq, d), generator=g, device=cuda).to(dtype)
    dlse = torch.randn((2, 3, sq), generator=g, device=cuda)
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off,
              scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=causal,
                                             q_offset=q_off,
                                             kv_offset=kv_off)
    c = attention.flash_bwd_prep(do, out, dlse)
    n_dq = attention.flash_bwd_dq_launches
    n_dkv = attention.flash_bwd_dkv_launches
    dq, dk, dv = attention._flash_bwd_cuda(q, k, v, do, lse, c, **kw)
    torch.cuda.synchronize()
    assert attention.flash_bwd_dq_launches == n_dq + 1
    assert attention.flash_bwd_dkv_launches == n_dkv + 1
    want_dq = attention.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)
    want_dk, want_dv = attention.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                         c, **kw)
    kpos = kv_off + torch.arange(sk, device=cuda)
    dead_k = (kpos > q_off + sq - 1 if causal
              else torch.zeros_like(kpos, dtype=torch.bool)).expand(2, 3, sk)
    for got, want, dead in ((dq, want_dq, ~torch.isfinite(lse)),
                            (dk, want_dk, dead_k), (dv, want_dv, dead_k)):
        assert got.shape == want.shape and got.dtype == dtype
        assert not torch.isnan(got).any()
        _rows_close(got, want, dead, rel)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("d,dtype", [
    (d, torch.bfloat16) for d in (64, 128, 32, 136, 160, 200, 248, 256,
                                  512)] + [
    # past 256 in chunks of 256, each chunk's block summing S in its own
    # chunk order and writing its own columns
    (d, t) for t in (torch.bfloat16, torch.float16) for d in (264, 1024)] + [
    # f32: the dq block's two warpgroups each sum their keys' share of dQ,
    # warpgroup 0 adding warpgroup 1's in a fixed order
    (d, torch.float32) for d in (64, 128, 256, 512)])
def test_dkv_kernel_is_deterministic(cuda, d, dtype, kernel):
    # Each dq row (dq kernel) and each dk/dv row (dk/dv kernel) is written
    # by one block, with no atomics: two launches on the same inputs give
    # the same bits.
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (torch.randn((2, 3, 328, d), generator=g, device=cuda)
                   .to(dtype) for _ in range(4))
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
    c = attention.flash_bwd_prep(do, out)
    launch = {"dq": lambda: (attention._flash_bwd_dq_cuda(
        q, k, v, do, lse, c, **kw),),
        "dkv": lambda: attention._flash_bwd_dkv_cuda(
            q, k, v, do, lse, c, **kw)}[kernel]
    first, second = launch(), launch()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,dtype", [
    (d, t) for t in (torch.bfloat16, torch.float16) for d in (256, 264, 512)]
    # f32: the split pass, then O in blocks of 64 columns, of 256 and of two
    # chunks of 256
    + [(d, torch.float32) for d in (64, 256, 512)])
def test_forward_kernel_is_deterministic(cuda, d, dtype):
    # Each block writes its own rows of out, and past 256 (f32: past 128)
    # its own chunk of them, every chunk's block forming the same S in the
    # same order (the one of chunk 0 writes lse), with no atomics: two
    # launches on the same inputs give the same bits, out and lse alike.
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((2, 3, 328, d), generator=g, device=cuda)
               .to(dtype) for _ in range(3))
    with torch.no_grad():
        first = attention.flash_attention(q, k, v, causal=True)
        second = attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3)])
@pytest.mark.parametrize("d", [64, 200, 256])
def test_kernels_read_the_qkv_views_in_place(cuda, dtype, rel, d):
    # q, k, v as the (B, H, S, D) views of one (B, S, 3 H D) buffer, as the
    # LM's projection hands them over (row stride 3 H D): TMA reads them
    # where they lie, and the three kernels agree with their plain versions
    g = torch.Generator(device=cuda).manual_seed(d)
    b, h, s = 2, 3, 200
    base = torch.randn((b, s, 3 * h * d), generator=g, device=cuda)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in base.to(dtype).split(h * d, dim=-1))
    assert not q.is_contiguous() and attention._aligned(q) is q
    do = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
        ref, ref_lse = attention.mha_reference(q, k, v, causal=True)
    _rows_close(out, ref, torch.zeros_like(lse, dtype=torch.bool), rel)
    c = attention.flash_bwd_prep(do, out)
    got = attention._flash_bwd_cuda(q, k, v, do, lse, c, **kw)
    torch.cuda.synchronize()
    want = (attention.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw),
            *attention.flash_bwd_dkv_reference(q, k, v, do, lse, c, **kw))
    for x, y in zip(got, want):
        _rows_close(x, y, torch.zeros_like(lse, dtype=torch.bool), rel)


def test_kernel_refuses_what_it_does_not_take(cuda):
    # What the kernels refuse: f64 (outside the reference's domain: the
    # JAX package never turns on jax_enable_x64), mixed dtypes, and a
    # head dim of 0. fp16 and head dims past 256 launch (the cases above).
    q = torch.zeros((1, 1, 16, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16, fp16 or f32"):
        attention.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 16, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16, fp16 or f32"):
        attention.flash_attention(q, q.bfloat16(), q)
    q = torch.zeros((1, 1, 16, 0), device=cuda)
    with pytest.raises(ValueError, match="head dims from 1 up"):
        attention.flash_attention(q, q, q, scale=1.0)


def test_backward_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 1, 16, 64), device=cuda)
    lse = torch.zeros((1, 1, 16), device=cuda)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=0.125)
    with pytest.raises(ValueError, match="do .* does not match"):
        attention._flash_bwd_cuda(q, q, q, q.bfloat16(), lse, lse, **kw)
    h = q.double()
    with pytest.raises(TypeError, match="bf16, fp16 or f32"):
        attention._flash_bwd_cuda(h, h, h, h, lse, lse, **kw)
    h = q.half()
    with pytest.raises(TypeError, match="bf16, fp16 or f32"):
        attention._flash_bwd_cuda(h, h.bfloat16(), h, h, lse, lse, **kw)
    empty = torch.zeros((1, 1, 16, 0), device=cuda)
    with pytest.raises(ValueError, match="head dims from 1 up"):
        attention._flash_bwd_cuda(empty, empty, empty, empty, lse, lse,
                                  **kw)


ROW_REL_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
               torch.float32: 1e-4}
LSE_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# queries (forward, dq) or keys (dk/dv) the plain versions take at a time
# on the long axis: each chunk's f32 copies stay near 0.5 GiB
PLAIN_CHUNK = 1 << 17


def _spans(n, step=PLAIN_CHUNK):
    return [(i, min(i + step, n)) for i in range(0, n, step)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,d,dtype,held", [
    # the batch past 65,535 (it lay on grid y, and on z in the f32
    # backward), in every dtype, at a tile width and in chunks of 256
    (65536, 1, 8, 8, 64, torch.bfloat16, "fwd dq dkv"),
    (65536, 1, 8, 8, 64, torch.float16, "fwd dq dkv"),
    (65536, 1, 8, 8, 64, torch.float32, "fwd dq dkv"),
    (65536, 1, 8, 8, 520, torch.bfloat16, "fwd dq dkv"),
    # the heads past 65,535 (on grid y in the f32 backward; bf16 had them
    # on x, and guards the fold)
    (1, 65536, 8, 8, 64, torch.float32, "fwd dq dkv"),
    (1, 65536, 8, 8, 64, torch.bfloat16, "fwd dq dkv"),
    # the chunked kernels' tile blocks past 65,535 at d 1024 (4 chunks): a
    # query axis of 2**21 (forward 65,536 blocks, dq 131,072) and a key
    # axis of 2**21 (dk/dv 131,072)
    (1, 1, 1 << 21, 64, 1024, torch.bfloat16, "fwd dq"),
    (1, 1, 64, 1 << 21, 1024, torch.bfloat16, "dkv")])
def test_kernels_take_grids_past_65535(cuda, b, h, sq, sk, d, dtype, held,
                                       causal):
    # What the reference's grid (B*H, Sq / bq, Sk / bk) takes, the port's
    # launches take: the three kernels agree with their plain versions
    # (taken a chunk of the long axis at a time) at each row's tolerance.
    # The long key axis puts its queries last (q_offset Sk - Sq), so that
    # causal, every key is seen.
    g = torch.Generator(device=cuda).manual_seed(b + h + sq + sk + d)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda, dtype=dtype)

    q, k, v = randn(b, h, sq, d), randn(b, h, sk, d), randn(b, h, sk, d)
    do = randn(b, sq, h, d).transpose(1, 2)
    q_off = sk - sq if causal and sk > sq else 0
    kw = dict(causal=causal, q_offset=q_off, kv_offset=0, scale=d ** -0.5)
    rel = ROW_REL_TOL[dtype]
    before = (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
              attention.flash_bwd_dkv_launches)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=causal,
                                             q_offset=q_off)
        c = attention.flash_bwd_prep(do, out)
        dq = attention._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw) \
            if "dq" in held else None
        dk, dv = attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c, **kw) \
            if "dkv" in held else (None, None)
        torch.cuda.synchronize()
        assert (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
                attention.flash_bwd_dkv_launches) == (
            before[0] + 1, before[1] + ("dq" in held),
            before[2] + ("dkv" in held))
        assert not torch.isnan(out).any() and not torch.isnan(lse).any()
        for i, j in _spans(sq) if held != "dkv" else ():
            rows = slice(i, j)
            if "fwd" in held:
                ref, ref_lse = attention.mha_reference(
                    q[:, :, rows], k, v, causal=causal, q_offset=q_off + i)
                live = torch.isfinite(ref_lse)
                assert torch.equal(torch.isfinite(lse[:, :, rows]), live)
                _rows_close(out[:, :, rows], ref, ~live, rel)
                assert (lse[:, :, rows][live] - ref_lse[live]).abs().max() \
                    <= LSE_TOL[dtype]
            if dq is not None:
                want = attention.flash_bwd_dq_reference(
                    q[:, :, rows], k, v, do[:, :, rows], lse[:, :, rows],
                    c[:, :, rows], **dict(kw, q_offset=q_off + i))
                assert not torch.isnan(dq[:, :, rows]).any()
                _rows_close(dq[:, :, rows], want,
                            ~torch.isfinite(lse[:, :, rows]), rel)
        for i, j in _spans(sk) if dk is not None else ():
            keys = slice(i, j)
            want_dk, want_dv = attention.flash_bwd_dkv_reference(
                q, k[:, :, keys], v[:, :, keys], do, lse, c,
                **dict(kw, kv_offset=i))
            kpos = torch.arange(i, j, device=cuda)
            dead = (kpos > q_off + sq - 1 if causal
                    else torch.zeros_like(kpos, dtype=torch.bool)
                    ).expand(b, h, j - i)
            for got, want in ((dk[:, :, keys], want_dk),
                              (dv[:, :, keys], want_dv)):
                assert not torch.isnan(got).any()
                _rows_close(got, want, dead, rel)


def test_f32_dq_single_key_rows(cuda):
    # The first query of each causal head sees one key: its dq row is p
    # (dP - c) k scale with dP equal to c up to rounding, a few millionths
    # of the largest row, under the check's floor. The f32 dq kernel forms
    # dP exactly (FP64 tensor cores) and rounds dP - c to f32 once, as the
    # plain version does; each row is held to the plain version and to the
    # same arithmetic in f64 at the f32 row tolerance. (One f32 dot product
    # for dP missed it here by 6.4e-4.)
    b, h, s, d = 1024, 1, 8, 64
    g = torch.Generator(device=cuda).manual_seed(b + h + s + d)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=cuda)
               for _ in range(3))
    do = torch.randn((b, s, h, d), generator=g, device=cuda).transpose(1, 2)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    before = attention.flash_bwd_dq_launches
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
        c = attention.flash_bwd_prep(do, out)
        dq = attention._flash_bwd_dq_cuda(q, k, v, do, lse, c, **kw)
        want = attention.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)
        q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
        sc = (q64 @ k64.transpose(-1, -2) * kw["scale"]).masked_fill(
            attention._causal_mask(s, s, 0, 0, cuda), float("-inf"))
        ds = torch.exp(sc - lse.double()[..., None]) * (
            do64 @ v64.transpose(-1, -2) - c.double()[..., None])
        exact = ds @ k64 * kw["scale"]
    torch.cuda.synchronize()
    assert attention.flash_bwd_dq_launches == before + 1
    dead = ~torch.isfinite(lse)
    assert not dead.any() and not torch.isnan(dq).any()
    _rows_close(dq, want, dead, ROW_REL_TOL[torch.float32])
    _rows_close(dq, exact, dead, ROW_REL_TOL[torch.float32])


def test_grid_past_grid_x_raises_value_error(cuda):
    # A launch grid past grid x's 2^31 - 1 blocks, or B * H past 2^31 - 1,
    # is refused by the C entry before any launch and raised as
    # ValueError (never a failed launch). The operands are views with zero
    # strides: the entries check the grid before they read a pointer.
    one = torch.zeros(64, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, device=cuda)
    for b, h, s in ((1 << 15, 1 << 15, 256),   # 2^30 heads x 2 tiles
                    (1 << 16, 1 << 15, 8)):    # B * H = 2^31
        x = one.expand(b, h, s, 64)
        with pytest.raises(ValueError, match="too large for one launch"):
            attention._fwd_launch("flash_fwd", x, x, x, None, x, lse)
        for name, outs in (("flash_bwd_dq", (x, None)),
                           ("flash_bwd_dkv", (x, x))):
            with pytest.raises(ValueError, match="too large for one launch"):
                attention._bwd_launch(name, x, x, x, x, lse, lse, outs,
                                      False, 0, 0, 0.125)


def test_block_backward_launches_both_kernels(cuda):
    # One training backward through a 2-layer model: each layer's
    # attention launches dq and dk/dv once; gradients agree with the same
    # model's on the CPU (plain backward), f32 atol 1e-4 of the largest.
    model = ttr.TransformerLM(vocab=128, dim=128, heads=2, layers=2,
                              compute_dtype=torch.float32, device=cuda)
    model.init_weights(torch.Generator(device=cuda).manual_seed(1))
    cpu = ttr.TransformerLM(vocab=128, dim=128, heads=2, layers=2,
                            compute_dtype=torch.float32, device="cpu")
    cpu.load_state_dict(model.state_dict())
    tok = torch.randint(0, 128, (2, 100), dtype=torch.int32)
    tgt = torch.randint(0, 128, (2, 100), dtype=torch.int32)
    pos = torch.arange(100, dtype=torch.int32).expand(2, 100)
    n = (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
         attention.flash_bwd_dkv_launches)
    ttr.lm_loss(model, tok.to(cuda), tgt.to(cuda), pos.to(cuda)).backward()
    torch.cuda.synchronize()
    assert (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
            attention.flash_bwd_dkv_launches) == tuple(x + 2 for x in n)
    ttr.lm_loss(cpu, tok, tgt, pos).backward()
    for (name, p), pc in zip(model.named_parameters(), cpu.parameters()):
        scale = float(pc.grad.abs().max())
        assert float((p.grad.cpu() - pc.grad).abs().max()) <= \
            1e-4 * max(scale, 1e-3), name


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


@pytest.mark.parametrize("windows", [1, 2, 3])
def test_readahead_epoch_on_the_card(cuda, windows):
    data = np.random.default_rng(0).integers(0, 256, (512, 784),
                                             dtype=np.uint8)
    with DDStore() as store:
        ds = ShardedDataset(store, data, np.arange(512, dtype=np.int32))
        samp = DistributedSampler(512, 1, 0, seed=3)
        got = {}
        for k in (0, windows):
            loader = DeviceLoader(ds, samp, 32, device=cuda,
                                  readahead_windows=k,
                                  readahead_window_batches=4)
            got[k] = [(x.cpu(), y.cpu()) for x, y in loader]
            assert loader.readahead_fallback_reason is None
        assert store.async_pending() == 0
        assert loader.metrics.summary()["readahead"]["windows"] == 4
    for (x0, y0), (x1, y1) in zip(got[0], got[windows]):
        assert torch.equal(x0, x1) and torch.equal(y0, y1)
        np.testing.assert_array_equal(x1.numpy(), data[y1.numpy()])
    assert len(got[windows]) == 16


def _vae_grads(model):
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def test_vae_step_on_the_card_matches_cpu(cuda):
    # the bf16 tolerances of tests/test_torch_vae.py: loss rtol 5e-3,
    # each gradient leaf 2e-2 of its largest magnitude
    cpu = vae.VAE(device="cpu").init_weights(torch.Generator().manual_seed(0))
    card = vae.VAE(device=cuda)
    card.load_state_dict(cpu.state_dict())
    raw = torch.randint(0, 256, (64, 784), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(1))
    eps = torch.randn((64, vae.LATENT),
                      generator=torch.Generator().manual_seed(2))
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        x = vae._dequantize(raw.to(dev))
        logits, mu, logvar = model(x, eps=eps.to(dev))
        loss = vae.loss_fn(logits, x, mu, logvar)
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[1] - losses[0]) <= 5e-3 * abs(losses[0])
    want, got = _vae_grads(cpu), _vae_grads(card)
    for n in want:
        scale = want[n].abs().max()
        assert (got[n] - want[n]).abs().max() <= 2e-2 * scale, n


def test_restored_adam_state_is_placed_as_a_stepped_one(cuda, tmp_path):
    """A train state saved from the card and restored into a fresh model
    and Adam puts every optimizer state tensor, Adam's 0-dim ``step``
    included, where the optimizer that was saved had it."""
    from ddstore_tpu_torch.utils import checkpoint

    def placement(model, opt):
        return [(i, k, v.device, v.dtype)
                for i, p in enumerate(model.parameters())
                for k, v in sorted(opt.state[p].items())]

    model = vae.VAE(device=cuda)
    _, opt = vae.create_train_state(model)
    vae.make_train_step(model, opt)(
        torch.rand((64, vae.IMAGE_DIM), device=cuda),
        generator=torch.Generator(device=cuda).manual_seed(0))
    path = str(tmp_path / "state.pt")
    checkpoint.save_train_state(path, {"model": model.state_dict(),
                                       "opt": opt.state_dict()})
    fresh = vae.VAE(device=cuda)
    _, fresh_opt = vae.create_train_state(fresh)
    got = checkpoint.restore_train_state(
        path, {"model": fresh.state_dict(), "opt": fresh_opt.state_dict()})
    fresh.load_state_dict(got["model"])
    fresh_opt.load_state_dict(got["opt"])
    want = placement(model, opt)
    assert any(k == "step" for _, k, _, _ in want)
    assert placement(fresh, fresh_opt) == want


def test_two_process_store_fed_step_on_the_card(cuda, tmp_path):
    from torch_workers import spawn, vae_store_fed

    ranks = spawn(2, vae_store_fed, str(tmp_path), 1024, 64, 2, "cuda")
    for r in ranks:
        assert all(np.isfinite(r["losses"])) and r["bytes_over_dcn"] > 0
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert len(set(ranks[0]["checksums"])) == 1


def _mpnn_step(weights, dtype, batch):
    """One MPNN step (Adam at lr 1e-3, as the tests) from ``weights`` on
    ``batch``'s device: the loss, the gradients and the parameters after
    the step, on the CPU."""
    model = gnn.MPNN(compute_dtype=dtype, device=batch.nodes.device)
    model.load_state_dict(weights)
    loss = float(gnn.make_train_step(
        model, gnn.create_train_state(model)[1])(batch))
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def _step_errors(run, ref, weights):
    """As ``chip_smoke.py``'s: the loss's relative error, the worst
    gradient leaf's L2 error over its L2 norm, the parameters' largest
    difference, and the share of weights stepped another way."""
    (loss, grads, after), (rloss, rgrads, rafter) = run, ref
    flips = sum(int((torch.sign(after[n] - w)
                     != torch.sign(rafter[n] - w)).sum())
                for n, w in weights.items())
    return (abs(loss - rloss) / abs(rloss),
            max(float((grads[n] - g).norm() / g.norm())
                for n, g in rgrads.items()),
            max(float((after[n] - a).abs().max()) for n, a in rafter.items()),
            flips / sum(w.numel() for w in weights.values()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mpnn_step_on_the_card_matches_cpu(cuda, dtype):
    gs = graphs.synthetic_graphs(np.random.default_rng(0), 16)
    with DDStore() as store:
        ds = graphs.GraphShardedDataset(store, gs, graphs_per_slot=8)
        gb = next(iter(DeviceLoader(ds, DistributedSampler(16, 1, 0), 16,
                                    device=cuda)))
    assert isinstance(gb, graphs.GraphBatch) and gb.nodes.is_cuda
    host = graphs.GraphBatch(*(t.cpu() for t in gb))
    weights = gnn.MPNN(device="cpu").init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    ref = _mpnn_step(weights, torch.float32, host)
    if dtype == torch.float32:
        loss, grad, step, _ = _step_errors(
            _mpnn_step(weights, dtype, gb), ref, weights)
        assert loss <= 1e-5 and grad <= 1e-4 and step <= 1e-4
        return
    # bf16 on the main path's atomic scatter: the card's error against
    # the f32 step within 3x the CPU's bf16 step's
    cpu = _step_errors(_mpnn_step(weights, dtype, host), ref, weights)
    for _ in range(4):
        card = _step_errors(_mpnn_step(weights, dtype, gb), ref, weights)
        assert card[0] <= max(3 * cpu[0], 2.0 ** -8), (card, cpu)
        assert card[1] <= 3 * cpu[1] and card[3] <= 3 * cpu[3], (card, cpu)


def test_nccl_device_collective_on_the_card(cuda, tmp_path):
    from torch_workers import nccl_collective, spawn

    (r,) = spawn(1, nccl_collective, str(tmp_path))
    assert r["fetch"] and r["loader"] and r["reason"] is None
    assert r["exchange_device"].startswith("cuda")
    assert r["summary"]["exchange_device"].startswith("cuda")
    assert r["summary"]["exchanges"] == 8
