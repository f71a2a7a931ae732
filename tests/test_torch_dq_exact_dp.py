"""The f32 dq's dP - c, formed from an exact dP and rounded once, emulated
on the CPU and held to the f64 arithmetic and to the JAX reference.

On the card the f32 dq kernel (``flash_bwd_dq_tf32_kernel``,
``ops/csrc/flash_bwd.cu``) forms S = Q K^T and dS K in three TF32
products (``tests/test_torch_tf32_split.py``), but dP = dO V^T on the
FP64 tensor cores: each product of two floats is exact in f64, the sums
round at 2^-53, and dS = P (dP - c) rounds dP - c to f32 once. The plain
versions (``flash_bwd_dq_reference``, ``flash_bwd_dkv_reference``) form
the same dP - c for f32 operands; they are the kernel's yardstick on the
card and the port's CPU path. A query that sees one key (the first of a
causal head, with no lse cotangent) has dP equal to c up to rounding, and
its dq row, p (dP - c) k scale, is then a few millionths of the largest
row: from an f32 dot product it would be that product's rounding alone.
The check of ``tests/test_torch_cuda.py`` holds each row within 1e-4 of
its norm, or of a thousandth of the largest row where the row is smaller
(``row_rel``): this file pins that the exact dP meets it against the f64
arithmetic on every row, where one f32 dot product does not, and that the
16-bit plain versions keep their f32 formula bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.ops import attention as jatt
from ddstore_tpu_torch.ops import attention as tatt
from test_torch_tf32_split import emulated_forward, matmul_tf32, row_rel

pytestmark = pytest.mark.tier1_required

ROW_REL = 1e-4
ATOL = 1e-5  # tests/test_torch_attention.py's f32 tolerance

# (b, h, s, d, q_offset, kv_offset), causal: the single-key first rows of
# 1,024 heads; the causal frontier shifted by q_offset; kv_offset past
# q_offset, so that the first 40 rows see no key (dq 0); three feature
# chunks of 32 past 64, the last one short.
CASES = [(1024, 1, 8, 64, 0, 0), (1, 2, 128, 64, 64, 0),
         (1, 2, 128, 64, 0, 40), (2, 2, 72, 72, 0, 0)]


def _t(x):
    return np.swapaxes(x, -1, -2)


def _scores_mask(sq, sk, q_offset, kv_offset):
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = kv_offset + np.arange(sk)[None]
    return kpos > qpos


def exact_dq(q, k, v, do, lse, c, q_offset, kv_offset, scale):
    """dq of the backward's arithmetic in f64 on the same inputs (the f32
    lse and c as given; a row of lse -inf taken as 1e30), causal."""
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    s = np.where(_scores_mask(q.shape[2], k.shape[2], q_offset, kv_offset),
                 -np.inf, q64 @ _t(k64) * scale)
    safe = np.where(np.isfinite(lse), lse, 1e30).astype(np.float64)
    ds = np.exp(s - safe[..., None]) * (do64 @ _t(v64)
                                        - c.astype(np.float64)[..., None])
    return ds @ k64 * scale


def emulated_dq(q, k, v, do, lse, c, q_offset, kv_offset, scale,
                dp_chain=False):
    """dq of the f32 kernel's arithmetic, causal: S summed a 32-feature
    chunk at a time through matmul_tf32 (each chunk afresh, added in f32),
    p = exp(S scale - lse) in f32, dP - c from dP in f64 rounded to f32
    once, dS = p (dP - c) in f32, dS K through matmul_tf32. ``dp_chain``:
    dP instead as one f32 fma chain over the features in order, the f32
    kernel's dP before it moved to the FP64 tensor cores."""
    d = q.shape[-1]
    s = np.zeros(q.shape[:-1] + k.shape[2:3], np.float32)
    for f0 in range(0, d, 32):
        s = s + matmul_tf32(q[..., f0:f0 + 32], _t(k[..., f0:f0 + 32]))
    s = np.where(_scores_mask(q.shape[2], k.shape[2], q_offset, kv_offset),
                 np.float32(-np.inf), s * np.float32(scale))
    safe = np.where(np.isfinite(lse), lse, np.float32(1e30))
    p = np.exp(s - safe[..., None]).astype(np.float32)
    if dp_chain:
        dp = np.zeros_like(p)
        for f in range(d):  # fmaf: the product exact, one rounding a step
            dp = (dp.astype(np.float64) + do[..., f:f + 1].astype(np.float64)
                  * _t(v[..., f:f + 1])).astype(np.float32)
        dmc = dp - c[..., None]
    else:
        dmc = (do.astype(np.float64) @ _t(v).astype(np.float64)
               - c.astype(np.float64)[..., None]).astype(np.float32)
    return matmul_tf32((p * dmc).astype(np.float32), k) * np.float32(scale)


def inputs(b, h, s, d, q_offset, kv_offset):
    """q, k, v, do from a numpy seed, then out and lse of the f32 forward
    kernel's arithmetic and c = rowsum(do out) (no lse cotangent)."""
    rng = np.random.default_rng(b + h + s + d + q_offset + kv_offset)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    scale = d ** -0.5
    out, lse = emulated_forward(q, k, v, True, q_offset, kv_offset, scale)
    c = np.sum(do * out, axis=-1, dtype=np.float32)
    return q, k, v, do, lse, c, scale


def check_rows(got, exact, lse, what, rel=ROW_REL):
    dead = ~np.isfinite(lse)
    assert (got[dead] == 0).all(), what
    err = float(row_rel(got, exact)[~dead].max())
    assert err <= rel, (what, err)
    return err


def _torch(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("b,h,s,d,q_offset,kv_offset", CASES)
def test_emulated_kernel_dq_within_tolerance_of_f64(b, h, s, d, q_offset,
                                                    kv_offset):
    q, k, v, do, lse, c, scale = inputs(b, h, s, d, q_offset, kv_offset)
    args = (q, k, v, do, lse, c, q_offset, kv_offset, scale)
    exact = exact_dq(*args)
    err = check_rows(emulated_dq(*args), exact, lse, "exact dP")
    if b == 1024:
        # the single-key rows: one f32 fma chain over the features misses
        # the check by its own rounding, the exact dP meets it
        chain = float(row_rel(emulated_dq(*args, dp_chain=True),
                              exact).max())
        assert chain > 2 * ROW_REL and chain > 100 * err, (chain, err)


@pytest.mark.parametrize("b,h,s,d,q_offset,kv_offset", CASES)
def test_emulated_kernel_dq_matches_reference(b, h, s, d, q_offset,
                                              kv_offset):
    q, k, v, do, _, _, scale = inputs(b, h, s, d, q_offset, kv_offset)
    blk = min(s, 64)
    kw = dict(causal=True, q_offset=q_offset, kv_offset=kv_offset,
              scale=scale, block_q=blk, block_k=blk, interpret=True)
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = np.asarray(vjp((jnp.asarray(do), jnp.zeros_like(lse)))[0],
                      np.float32)
    lse = np.asarray(lse, np.float32)
    c = np.sum(do * np.asarray(out, np.float32), axis=-1, dtype=np.float32)
    got = emulated_dq(q, k, v, do, lse, c, q_offset, kv_offset, scale)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,h,s,d,q_offset,kv_offset", CASES)
def test_plain_f32_dq_within_tolerance_of_f64(b, h, s, d, q_offset,
                                              kv_offset):
    q, k, v, do, lse, c, scale = inputs(b, h, s, d, q_offset, kv_offset)
    exact = exact_dq(q, k, v, do, lse, c, q_offset, kv_offset, scale)
    tq, tk, tv, tdo, tlse, tc = _torch(q, k, v, do, lse, c)
    kw = dict(causal=True, q_offset=q_offset, kv_offset=kv_offset,
              scale=scale)
    got = tatt.flash_bwd_dq_reference(tq, tk, tv, tdo, tlse, tc, **kw)
    assert got.dtype == torch.float32
    check_rows(got.numpy(), exact, lse, "plain dq")
    if b == 1024:
        # the f32 dot product the plain version formed before misses
        p = tatt._probs(tq, tk, tlse, True, q_offset, kv_offset, scale)
        old = (p * (tdo @ tv.transpose(-1, -2) - tc[..., None])) @ tk * scale
        assert float(row_rel(old.numpy(), exact).max()) > 2 * ROW_REL


@pytest.mark.parametrize("b,h,s,d,q_offset,kv_offset", CASES[1:])
def test_plain_f32_dkv_within_tolerance_of_f64(b, h, s, d, q_offset,
                                               kv_offset):
    q, k, v, do, lse, c, scale = inputs(b, h, s, d, q_offset, kv_offset)
    q64, k64, v64, do64 = (x.astype(np.float64) for x in (q, k, v, do))
    sc = np.where(_scores_mask(s, s, q_offset, kv_offset), -np.inf,
                  q64 @ _t(k64) * scale)
    safe = np.where(np.isfinite(lse), lse, 1e30).astype(np.float64)
    p = np.exp(sc - safe[..., None])
    ds = p * (do64 @ _t(v64) - c.astype(np.float64)[..., None])
    dk, dv = tatt.flash_bwd_dkv_reference(
        *_torch(q, k, v, do, lse, c), causal=True, q_offset=q_offset,
        kv_offset=kv_offset, scale=scale)
    dead = kv_offset + np.arange(s) > q_offset + s - 1
    # keys no query sees: dk and dv 0
    key_lse = np.broadcast_to(np.where(dead, -np.inf, 0.0), (b, h, s))
    check_rows(dk.numpy(), _t(ds) @ q64 * scale, key_lse, "plain dk")
    check_rows(dv.numpy(), _t(p) @ do64, key_lse, "plain dv")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_16bit_backward_keeps_its_f32_formula(dtype):
    b, h, s, d = 2, 3, 72, 40
    q, k, v, do, lse, c, scale = inputs(b, h, s, d, 8, 0)
    q, k, v, do = (x.to(dtype) for x in _torch(q, k, v, do))
    lse, c = _torch(lse, c)
    kw = dict(causal=True, q_offset=8, kv_offset=0, scale=scale)
    dq = tatt.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)
    dk, dv = tatt.flash_bwd_dkv_reference(q, k, v, do, lse, c, **kw)
    # the formula as it stood: dp and dp - c in f32, p (dp - c) in f32
    p = tatt._probs(q, k, lse, True, 8, 0, scale)
    t = p * (torch.matmul(do.float(), v.float().transpose(-1, -2))
             - c[..., None].float())
    want_dq = (torch.matmul(t.to(dtype).float(), k.float()) * scale).to(dtype)
    want_dk = (torch.matmul(t.to(dtype).float().transpose(-1, -2),
                            q.float()) * scale).to(dtype)
    want_dv = torch.matmul(p.to(dtype).float().transpose(-1, -2),
                           do.float()).to(dtype)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert torch.equal(dq, want_dq)
    assert torch.equal(dk, want_dk)
    assert torch.equal(dv, want_dv)
