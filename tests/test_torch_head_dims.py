"""The port's attention at every head dim the JAX kernel takes, up to 256.

The reference's Pallas kernels take any head dim (their blocks' last dim
is the whole array's), and its model sends every block through them at
``dim // heads``. On the card the port's kernels run tiles of 64, 128 and
256 features: the wrappers zero-pad a head dim that is not a multiple of
8 to the next one (``_kernel_width``), and in the tile TMA or the loads
zero-fill the columns past it. These tests pin, on the CPU:

* the plain forward and backward (what the kernels are held against on
  the card) against the JAX ``flash_attention`` in interpret mode at each
  head dim, causal and not: out, lse, dq, dk and dv at f32 atol 1e-5
  (summation order only), with an lse cotangent;
* the width logic: every head dim from 1 to 256 maps to a multiple of 8
  and a tile that holds it, and wider head dims raise with the limit;
* the zero-fill argument the kernels rest on, through the plain versions:
  zero feature columns added to q, k, v and do (with the scale of the
  true head dim) leave out, lse and the gradients' first d columns as
  they are, and give zero gradients in the added columns.

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
HEAD_DIMS = (8, 16, 20, 32, 40, 96, 160, 256)


def _inputs(seed, d, b=1, h=2, s=64):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.normal(size=(b, h, s)).astype(np.float32)
    return q, k, v, do, dlse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_versions_match_jax_flash_at_head_dim(d, causal):
    q, k, v, do, dlse = _inputs(d, d)
    (jo, jl), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(q, k, v, causal=causal,
                                             block_q=64, block_k=64),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    to, tl = tatt.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((to, tl), ts, (torch.from_numpy(do),
                                             torch.from_numpy(dlse)))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               atol=ATOL, rtol=0, err_msg="out")
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=ATOL, rtol=0, err_msg="lse")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (1, 2, 64, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_kernel_width_covers_every_head_dim():
    tiles = set()
    for d in range(1, tatt.MAX_HEAD_DIM + 1):
        width, tile = tatt._kernel_width(d)
        assert width % 8 == 0 and d <= width < d + 8
        assert tile in (64, 128, 256) and width <= tile
        # the narrowest tile that holds it
        assert all(t < width for t in (64, 128, 256) if t < tile)
        tiles.add(tile)
    assert tiles == {64, 128, 256}
    assert tatt._kernel_width(64) == (64, 64)
    assert tatt._kernel_width(20) == (24, 64)
    assert tatt._kernel_width(129) == (136, 256)


@pytest.mark.parametrize("d", [0, 257, 264])
def test_kernel_width_refuses_past_the_limit(d):
    with pytest.raises(ValueError, match="head dims 1 to 256"):
        tatt._kernel_width(d)


@pytest.mark.parametrize("d,width", [(20, 24), (36, 40), (32, 64),
                                     (160, 256)])
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
