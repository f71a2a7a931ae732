"""The arithmetic of the port's f32 flash kernels, emulated on the CPU and
held to the JAX reference's kernels.

On the card the f32 forward (``ops/csrc/flash_fwd.cu``) and the f32 dq and
dk/dv kernels (``ops/csrc/flash_bwd.cu``) run their f32 products on the
tensor cores in TF32, as three products (dq's dP excepted: an f32 dot
product on the CUDA cores): with ``hi = rna_tf32(x)`` (round to nearest,
ties away from zero, to 10 explicit mantissa bits) and ``lo = rna_tf32(x -
hi)``, ``a b`` becomes ``a_hi b_hi + a_hi b_lo + a_lo b_hi``, each k-step
of 8 terms rounded to f32 once and the k-steps summed in f32. The card
alone runs the kernels; this file pins the reasoning they rest on: the
emulations below, in numpy, give out and lse (the forward) and dq, dk and
dv within the kernels' f32 tolerance (1e-4 of each row's L2 norm, or of a
thousandth of the largest row where the row is smaller, as
``chip_smoke.row_errors``; lse within 1e-4) of the JAX reference's
``_flash_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, run in
interpret mode as ``tests/test_attention.py`` runs them, while one TF32
pass lands at least ten times further away.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ddstore_tpu.ops import attention as jatt

pytestmark = pytest.mark.tier1_required

ROW_REL = 1e-4


def tf32(x):
    """x rounded to TF32 on its f32 bit pattern: round to nearest, ties
    away from zero (``cvt.rna.tf32.f32``), the 13 low mantissa bits 0."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
        .view(np.float32)


def split(x):
    """(hi, lo) of the kernels' three-product split, in f32."""
    x = np.asarray(x, np.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32(a, b, passes=3):
    """a @ b over the last two dims as the kernels form it: per k-step of 8,
    the products (exact in f64: a TF32 value has 11 significant bits)
    summed and rounded to f32 once, the k-steps summed in f32. passes=3:
    hi hi + hi lo + lo hi; passes=1: one TF32 product."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        step = ah[..., ks].astype(np.float64) @ bh[..., ks, :]
        if passes == 3:
            step += ah[..., ks].astype(np.float64) @ bl[..., ks, :]
            step += al[..., ks].astype(np.float64) @ bh[..., ks, :]
        acc = acc + step.astype(np.float32)
    return acc


def emulated_backward(q, k, v, do, lse, c, causal, q_offset, kv_offset,
                      scale, passes=3):
    """(dq, dk, dv) of the f32 kernels' arithmetic: s = q k^T scale, p =
    exp(s - lse) (a fully-masked row, lse -inf, taken as 1e30), dp = do
    v^T, ds = p (dp - c); dq = ds k scale, dk = ds^T q scale, dv = p^T
    do, every product through matmul_tf32."""
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    s = matmul_tf32(q, t(k), passes) * np.float32(scale)
    if causal:
        qpos = q_offset + np.arange(q.shape[2])[:, None]
        kpos = kv_offset + np.arange(k.shape[2])[None]
        s = np.where(kpos > qpos, np.float32(-np.inf), s)
    safe = np.where(np.isfinite(lse), lse, np.float32(1e30))
    p = np.exp(s - safe[..., None]).astype(np.float32)
    dp = matmul_tf32(do, t(v), passes)
    ds = (p * (dp - c[..., None])).astype(np.float32)
    return (matmul_tf32(ds, k, passes) * np.float32(scale),
            matmul_tf32(t(ds), q, passes) * np.float32(scale),
            matmul_tf32(t(p), do, passes))


def emulated_forward(q, k, v, causal, q_offset, kv_offset, scale,
                     passes=3):
    """(out, lse) of the f32 forward kernel's arithmetic: O's columns in a
    block of 64, 128 or 256 (past 128) and key tiles of 64 keys (32 at
    256); per key tile S = q k^T summed a 32-feature chunk (4 k-steps) at a
    time, each chunk afresh and added in f32; the online softmax over the
    tile (running max m and sum l in f32); P split as the kernel splits
    its accumulators, the tile's P V summed afresh through matmul_tf32 and
    added into O in f32; out = O / l and lse = m + log l (a row no key
    reaches: out 0, lse -inf)."""
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    bn = 32 if d > 128 else 64
    qpos = q_offset + np.arange(sq)[:, None]
    m = np.full(q.shape[:-1] + (1,), -np.inf, np.float32)
    l = np.zeros_like(m)
    o = np.zeros(q.shape[:-1] + v.shape[-1:], np.float32)
    for k0 in range(0, sk, bn):
        kt, vt = k[..., k0:k0 + bn, :], v[..., k0:k0 + bn, :]
        s = np.zeros(q.shape[:-1] + kt.shape[-2:-1], np.float32)
        for f0 in range(0, d, 32):
            s = s + matmul_tf32(q[..., f0:f0 + 32],
                                np.swapaxes(kt[..., f0:f0 + 32], -1, -2),
                                passes)
        s = s * np.float32(scale)
        kpos = kv_offset + k0 + np.arange(kt.shape[-2])[None]
        if causal:
            s = np.where(kpos > qpos, np.float32(-np.inf), s)
        m_new = np.maximum(m, s.max(axis=-1, keepdims=True))
        safe = np.where(np.isfinite(m_new), m_new, np.float32(0))
        corr = np.where(np.isfinite(m), np.exp(m - safe), np.float32(0))
        p = np.exp(s - safe).astype(np.float32)
        l = (l * corr + p.sum(axis=-1, keepdims=True)).astype(np.float32)
        o = (o * corr + matmul_tf32(p, vt, passes)).astype(np.float32)
        m = m_new
    out = o / np.maximum(l, np.float32(1e-30))
    lse = np.where(np.isfinite(m), m + np.log(np.maximum(l, 1e-30)),
                   np.float32(-np.inf))[..., 0].astype(np.float32)
    return out, lse


def row_rel(got, want):
    """Each row's L2 error over the head dim relative to the row of
    ``want``, or to a thousandth of its largest row where the row is
    smaller (``chip_smoke.row_rel``)."""
    norm = np.linalg.norm(want, axis=-1)
    floor = 1e-3 * float(norm.max())
    return np.linalg.norm(got - want, axis=-1) / np.maximum(norm, floor)


def test_tf32_rounding_of_the_bit_pattern():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)) \
        .astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert not (lo.view(np.uint32) & np.uint32(0x1FFF)).any()
    # round to nearest: within half a TF32 ulp (2^-11 relative); hi + lo
    # within 2^-22 of x
    assert (np.abs(x - hi) <= np.abs(x) * 2.0 ** -11).all()
    assert (np.abs(x.astype(np.float64) - hi - lo)
            <= np.abs(x) * 2.0 ** -22).all()
    # ties go away from zero, as cvt.rna does
    one = np.float32(1.0)
    tie = np.float32(1.0 + 2.0 ** -11)
    assert tf32(tie) == np.float32(1.0 + 2.0 ** -10)
    assert tf32(-tie) == -np.float32(1.0 + 2.0 ** -10)
    assert tf32(one) == one


@pytest.mark.parametrize("causal,q_offset,kv_offset,d", [
    (False, 0, 0, 64),
    (True, 0, 0, 64),
    (True, 0, 0, 136),
    (False, 0, 0, 136),
    # offsets shift the causal frontier
    (True, 64, 0, 64),
    # kv_offset past q_offset: the first rows see no key (lse -inf): their
    # dq is 0, as are dk and dv of the keys no query sees
    (True, 0, 40, 64),
])
def test_split_matches_reference_backward(causal, q_offset, kv_offset, d):
    rng = np.random.default_rng(d + q_offset + kv_offset + causal)
    b, h, s = 1, 2, 128
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.normal(size=(b, h, s)).astype(np.float32)
    scale = d ** -0.5
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              scale=scale, block_q=64, block_k=64, interpret=True)
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, **kw),
        *(jnp.asarray(a) for a in (q, k, v)))
    lse = np.asarray(lse)
    dlse = np.where(np.isfinite(lse), dlse, 0).astype(np.float32)
    want = [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    # c = rowsum(do * out) - dlse, as the reference forms it
    c = (np.sum(do * np.asarray(out, np.float32), axis=-1,
                dtype=np.float32) - dlse).astype(np.float32)
    got3 = emulated_backward(q, k, v, do, lse, c, causal, q_offset,
                             kv_offset, scale)
    got1 = emulated_backward(q, k, v, do, lse, c, causal, q_offset,
                             kv_offset, scale, passes=1)
    dead_q = ~np.isfinite(lse)
    assert dead_q.any() == (kv_offset > q_offset)
    assert (got3[0][dead_q] == 0).all()
    if causal:
        dead_k = kv_offset + np.arange(s) > q_offset + s - 1
        assert (got3[1][:, :, dead_k] == 0).all()
        assert (got3[2][:, :, dead_k] == 0).all()
    for name, w, g3, g1 in zip(("dq", "dk", "dv"), want, got3, got1):
        e3 = float(row_rel(g3, w).max())
        e1 = float(row_rel(g1, w).max())
        assert e3 <= ROW_REL, (name, e3)
        # one TF32 pass misses the tolerance; the split is what meets it
        assert e1 >= 10 * e3, (name, e1, e3)


@pytest.mark.parametrize("causal,q_offset,kv_offset,d", [
    (False, 0, 0, 64),
    (True, 0, 0, 64),
    (True, 0, 0, 136),
    (False, 0, 0, 136),
    # O's columns in a block of 256, key tiles of 32
    (True, 0, 0, 264),
    (False, 0, 0, 264),
    # offsets shift the causal frontier
    (True, 64, 0, 64),
    # kv_offset past q_offset: the first 40 rows see no key (out 0, lse
    # -inf)
    (True, 0, 40, 64),
    (True, 0, 40, 264),
])
def test_split_matches_reference_forward(causal, q_offset, kv_offset, d):
    rng = np.random.default_rng(7 * d + q_offset + kv_offset + causal)
    b, h, s = 1, 2, 128
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    scale = d ** -0.5
    out, lse = jatt.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_offset=q_offset, kv_offset=kv_offset, scale=scale, block_q=64,
        block_k=64, interpret=True)
    out, lse = np.asarray(out, np.float32), np.asarray(lse, np.float32)
    got3 = emulated_forward(q, k, v, causal, q_offset, kv_offset, scale)
    got1 = emulated_forward(q, k, v, causal, q_offset, kv_offset, scale,
                            passes=1)
    dead = ~np.isfinite(lse)
    assert dead.any() == (kv_offset > q_offset)
    assert (~np.isfinite(got3[1]) == dead).all()
    assert (got3[0][dead] == 0).all()
    e3 = float(row_rel(got3[0], out)[~dead].max())
    e1 = float(row_rel(got1[0], out)[~dead].max())
    assert e3 <= ROW_REL, e3
    assert float(np.abs(got3[1][~dead] - lse[~dead]).max()) <= 1e-4
    # one TF32 pass misses the tolerance; the split is what meets it
    assert e1 >= 10 * e3, (e1, e3)
