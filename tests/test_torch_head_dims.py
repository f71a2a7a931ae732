"""The port's attention at every head dim and dtype the JAX kernel takes.

The reference's Pallas kernels take any head dim (their blocks' last dim
is the whole array's) and any float dtype, and its model sends every
block through them at ``dim // heads`` in its compute dtype. On the card
the port's kernels run tiles of 64, 128 and 256 features, and chunks of
256 past that: the wrappers zero-pad a head dim that is not a multiple
of 8 to the next one (``_kernel_width``), and in the last tile TMA or
the loads zero-fill the columns past it. These tests pin, on the CPU:

* the plain forward and backward (what the kernels are held against on
  the card) against the JAX ``flash_attention`` in interpret mode at each
  head dim, causal and not, with an lse cotangent: out, lse, dq, dk and
  dv in f32 at atol 1e-5 (summation order only), and in fp16 at
  ``FP16_ULPS`` units of fp16 rounding (2**-11) of each output's largest
  magnitude, lse at 1e-5;
* the width logic: every head dim from 1 to 2048 maps to a multiple of
  8, a tile and a chunk count that cover it; d 0 raises;
* the zero-fill argument the kernels rest on, through the plain versions:
  zero feature columns added to q, k, v and do (with the scale of the
  true head dim) leave out, lse and the gradients' first d columns as
  they are, and give zero gradients in the added columns, also where the
  zero columns run across a chunk's edge (256).

The kernels themselves are held against the plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s head-dims phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.ops import attention as jatt
from ddstore_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.tier1_required

ATOL = 1e-5
# below, inside and above the 64 and 128 tiles, not a multiple of 8 (20,
# 300, 1000), the 256 tile's edge, and past it in 2 to 4 chunks of 256
HEAD_DIMS = (8, 16, 20, 32, 40, 96, 160, 256, 264, 300, 320, 512, 520,
             1000)
# fp16: both sides round out, P and dS to fp16 (unit 2**-11), the JAX
# kernel its P before P V where the plain forward rounds only out, and
# the two sum in other orders; the worst error seen over these head dims
# was 1.97 units of the output's largest magnitude (dq, d 160 causal).
FP16_ULPS = 4


def _inputs(seed, d, b=1, h=2, s=64, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(dtype)
                   for _ in range(4))
    dlse = rng.normal(size=(b, h, s)).astype(np.float32)
    return q, k, v, do, dlse


def _against_jax_flash(d, causal, dtype):
    """The plain forward and backward against the JAX flash in interpret
    mode on the same inputs: {name: (port's, reference's)} of out, lse,
    dq, dk, dv as f32 numpy arrays, after checking the dtypes."""
    q, k, v, do, dlse = _inputs(d, d, dtype=dtype)
    (jo, jl), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, causal=causal,
                                             block_q=64, block_k=64),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to, tl = tatt.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((to, tl), ts, (torch.from_numpy(do),
                                             torch.from_numpy(dlse)))
    tdt = torch.from_numpy(q).dtype
    assert to.dtype == tdt and tl.dtype == torch.float32
    pairs = {"out": (to, jo), "lse": (tl, jl)}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (1, 2, 64, d) and g.dtype == tdt
        assert np.asarray(w).dtype == dtype
        pairs[name] = (g, w)
    return {n: (t.detach().float().numpy(), np.asarray(w, np.float32))
            for n, (t, w) in pairs.items()}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_versions_match_jax_flash_at_head_dim(d, causal):
    for name, (got, want) in _against_jax_flash(d, causal,
                                                np.float32).items():
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_versions_match_jax_flash_in_fp16(d, causal):
    for name, (got, want) in _against_jax_flash(d, causal,
                                                np.float16).items():
        tol = ATOL if name == "lse" else \
            FP16_ULPS * 2.0 ** -11 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=name)


def test_kernel_width_covers_every_head_dim():
    tiles = set()
    for d in range(1, 2049):
        width, tile, chunks = tatt._kernel_width(d)
        assert width % 8 == 0 and d <= width < d + 8
        assert tile in (64, 128, 256)
        # the chunks cover the width, and no chunk is all past it
        assert tile * (chunks - 1) < width <= tile * chunks
        if width <= 256:
            # one chunk: the narrowest tile that holds it
            assert chunks == 1
            assert all(t < width for t in (64, 128, 256) if t < tile)
        else:
            assert tile == 256 and chunks == -(-width // 256)
        tiles.add(tile)
    assert tiles == {64, 128, 256}
    assert tatt._kernel_width(64) == (64, 64, 1)
    assert tatt._kernel_width(20) == (24, 64, 1)
    assert tatt._kernel_width(129) == (136, 256, 1)
    assert tatt._kernel_width(300) == (304, 256, 2)
    assert tatt._kernel_width(1024) == (1024, 256, 4)
    assert tatt._kernel_width(2048) == (2048, 256, 8)


@pytest.mark.parametrize("d", [0, 257, 264])
def test_kernel_width_refuses_past_the_limit(d):
    # The only limit is d >= 1: past 256 (257, 264) the kernels take
    # chunks of 256 features.
    if d < 1:
        with pytest.raises(ValueError, match="head dims from 1 up"):
            tatt._kernel_width(d)
    else:
        assert tatt._kernel_width(d) == (264, 256, 2)


@pytest.mark.parametrize("d,width", [(20, 24), (36, 40), (32, 64),
                                     (160, 256),
                                     # across a chunk's edge: the pad to a
                                     # multiple of 8, then the last chunk's
                                     # zero fill from 264 (or 304) to 512
                                     (260, 512), (300, 512)])
def test_zero_columns_leave_attention_as_it_is(d, width):
    # The kernels read q, k, v and do with zero columns from d up to the
    # width they run (a pad to a multiple of 8, then the tile's zero
    # fill), at the scale of the true d.
    q, k, v, do, dlse = (torch.from_numpy(a) for a in _inputs(7, d, s=40))
    qp, kp, vp, dop = (tatt._padded(t, width) for t in (q, k, v, do))
    assert qp.shape[-1] == width and torch.equal(qp[..., :d], q)
    assert (qp[..., d:] == 0).all()
    assert tatt._padded(q, d) is q
    kw = dict(causal=True, q_offset=8, kv_offset=0, scale=d ** -0.5)
    out, lse = tatt.mha_reference(q, k, v, **kw)
    out_p, lse_p = tatt.mha_reference(qp, kp, vp, **kw)
    torch.testing.assert_close(out_p[..., :d], out, atol=ATOL, rtol=0)
    assert (out_p[..., d:] == 0).all()
    torch.testing.assert_close(lse_p, lse, atol=ATOL, rtol=0)
    c = tatt.flash_bwd_prep(do, out, dlse)
    c_p = tatt.flash_bwd_prep(dop, out_p, dlse)
    torch.testing.assert_close(c_p, c, atol=ATOL, rtol=0)
    dq = tatt.flash_bwd_dq_reference(q, k, v, do, lse, c, **kw)
    dk, dv = tatt.flash_bwd_dkv_reference(q, k, v, do, lse, c, **kw)
    dq_p = tatt.flash_bwd_dq_reference(qp, kp, vp, dop, lse_p, c_p, **kw)
    dk_p, dv_p = tatt.flash_bwd_dkv_reference(qp, kp, vp, dop, lse_p, c_p,
                                              **kw)
    for got, want in ((dq_p, dq), (dk_p, dk), (dv_p, dv)):
        torch.testing.assert_close(got[..., :d], want, atol=ATOL, rtol=0)
        assert (got[..., d:] == 0).all()
