"""The arithmetic of the port's 16-bit dq kernel past head dim 256,
emulated on the CPU and held to the JAX reference's kernel.

On the card ``flash_bwd_dq_chunked_kernel`` (``ops/csrc/flash_bwd.cu``)
runs bf16 and fp16 dq at d > 256 in chunks of 256 features: one block per
64 queries and chunk ``oc`` of dQ's columns, 64-key tiles up to the last
live one, S = Q K^T and dP = dO V^T summed in f32 one chunk at a time in
the order oc + 1, ..., nc - 1, 0, ..., oc (TMA zero-fills the columns past
d), P = exp2(S scale log2e - lse log2e) and dS = P (dP - c) in f32, dS
rounded to the input dtype, dQ's chunk summed over the key tiles in f32,
times the scale and rounded once. The card alone runs the kernel; this
file pins where it sums over the chunks and where it rounds, not its
speed: the emulation below lands within the tolerance of
``tests/test_torch_head_dims.py`` (4 units of the dtype's rounding, 2**-11
in fp16 and 2**-8 in bf16, of the largest |dq|) of the JAX package's
``_bwd_dq_kernel``, run in interpret mode, and of the plain
``flash_bwd_dq_reference``, which stays the kernel's yardstick on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddstore_tpu.ops import attention as jatt
from ddstore_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.tier1_required

LOG2E = 1.4426950408889634
CHUNK = 256  # features a chunk
BQ = BK = 64  # queries a block, keys a tile
# units of the dtype's rounding of the largest |dq| (test_torch_head_dims)
ULPS = 4
UNIT = {np.float16: 2.0 ** -11, jnp.bfloat16: 2.0 ** -8}
TORCH = {np.float16: torch.float16, jnp.bfloat16: torch.bfloat16}


def chunk_order(oc, nc):
    """The chunks in the order a block of dQ chunk ``oc`` sums them: its
    own last, so that its K chunk is still in shared memory for dQ."""
    return [(oc + 1 + x) % nc for x in range(nc)]


def emulated_dq(q, k, v, do, lse, c, causal, q_offset, kv_offset, scale):
    """dq of the chunked kernel's arithmetic on (B, H, S, D) tensors of the
    input dtype; lse and c f32 (B, H, Sq)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nc = -(-d // CHUNK)
    # the tiles' columns past d are TMA's zero fill
    pad = (0, nc * CHUNK - d)
    qf, kf, vf, dof = (torch.nn.functional.pad(x.float(), pad)
                       for x in (q, k, v, do))
    lse2 = torch.where(torch.isfinite(lse), lse,
                       torch.full_like(lse, 1e30)) * LOG2E
    sl2 = scale * LOG2E
    dq = torch.zeros((b, h, sq, nc * CHUNK))
    for q0 in range(0, sq, BQ):
        rows = slice(q0, min(q0 + BQ, sq))
        qpos = q_offset + torch.arange(rows.start, rows.stop)[:, None]
        # key tiles up to the last live one
        last = q_offset + rows.stop - 1 - kv_offset
        n = -(-sk // BK) if not causal else \
            (0 if last < 0 else min(last // BK + 1, -(-sk // BK)))
        for oc in range(nc):
            own = slice(oc * CHUNK, (oc + 1) * CHUNK)
            acc = torch.zeros((b, h, rows.stop - q0, CHUNK))
            for i in range(n):
                keys = slice(i * BK, min(i * BK + BK, sk))
                s = dp = 0
                for ch in chunk_order(oc, nc):
                    cs = slice(ch * CHUNK, (ch + 1) * CHUNK)
                    s = s + qf[..., rows, cs] @ \
                        kf[..., keys, cs].transpose(-1, -2)
                    dp = dp + dof[..., rows, cs] @ \
                        vf[..., keys, cs].transpose(-1, -2)
                x = s * sl2 - lse2[..., rows, None]
                if causal:
                    kpos = kv_offset + torch.arange(keys.start, keys.stop)
                    x = x.masked_fill(kpos[None] > qpos, float("-inf"))
                ds = torch.exp2(x) * (dp - c[..., rows, None])
                acc = acc + ds.to(q.dtype).float() @ kf[..., keys, own]
            dq[..., rows, own] = acc * scale
    return dq[..., :d].to(q.dtype)


@pytest.mark.parametrize("dt", [jnp.bfloat16, np.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("d,causal,sq,sk,q_offset,kv_offset", [
    # two chunks, the second 8 features wide
    (264, True, 128, 128, 0, 0),
    (264, False, 128, 128, 0, 0),
    # two full chunks
    (512, True, 192, 192, 0, 0),
    (512, False, 128, 128, 0, 0),
    # a partial third chunk; and Sk not a multiple of the 64-key tile
    (520, True, 128, 128, 0, 0),
    (520, False, 128, 136, 0, 0),
    # q_offset moves the causal frontier inside a 64-query block
    (512, True, 128, 128, 32, 0),
    # kv_offset ahead by 40: the first 40 rows see no key (lse -inf, dq 0)
    (264, True, 192, 192, 0, 40),
    (520, True, 128, 128, 0, 40),
])
def test_chunked_dq_matches_reference(dt, d, causal, sq, sk, q_offset,
                                      kv_offset):
    rng = np.random.default_rng(d + sq + sk + q_offset + kv_offset + causal)
    b, h = 1, 2
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, h, sk, d)).astype(np.float32)
            for _ in range(2))
    dlse = rng.normal(size=(b, h, sq)).astype(np.float32)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dt) for x in (q, k, v, do))
    (out, lse), vjp = jax.vjp(
        lambda q, k, v: jatt.flash_attention(
            q, k, v, causal=causal, q_offset=q_offset, kv_offset=kv_offset,
            scale=scale, block_q=64, block_k=64, interpret=True),
        jq, jk, jv)
    lse = np.array(lse, np.float32)
    dlse = np.where(np.isfinite(lse), dlse, 0).astype(np.float32)
    want = np.asarray(vjp((jdo, jnp.asarray(dlse)))[0], np.float32)

    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32))
                       .to(TORCH[dt]) for x in (jq, jk, jv, jdo))
    tout = torch.from_numpy(np.asarray(out, np.float32)).to(TORCH[dt])
    tlse = torch.from_numpy(lse)
    # c = rowsum(do * out) - dlse in f32, as the reference forms it
    c = tatt.flash_bwd_prep(tdo, tout, torch.from_numpy(dlse))
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
              scale=scale)
    got = emulated_dq(tq, tk, tv, tdo, tlse, c, **kw)
    plain = tatt.flash_bwd_dq_reference(tq, tk, tv, tdo, tlse, c, **kw)
    assert got.shape == (b, h, sq, d) and got.dtype == TORCH[dt]

    dead = ~np.isfinite(lse)
    assert dead.any() == (kv_offset > q_offset)
    assert (got.float().numpy()[dead] == 0).all()
    tol = ULPS * UNIT[dt] * float(np.abs(want).max())
    for name, ref in (("jax", want), ("plain", plain.float().numpy())):
        np.testing.assert_allclose(got.float().numpy(), ref, atol=tol,
                                   rtol=0, err_msg=name)

