"""Attention: the flash-attention kernels, forward and backward, and their
plain versions.

The port of ``ddstore_tpu/ops/attention.py``. Every function takes
(B, H, S, D) tensors; the forward returns ``(out, lse)``, where ``lse``
is the per-query log-sum-exp of the scores in f32, (B, H, S).

* :func:`mha_reference` is the plain PyTorch forward (``attention.py:
  64-89``): it materializes the scores, and is what the CPU runs.
* :func:`flash_bwd_prep`, :func:`flash_bwd_dq_reference` and
  :func:`flash_bwd_dkv_reference` are the plain backward (``_flash_bwd``
  ``:334-408`` and its two kernels ``:213-313``), rounding to the input
  dtype where the kernels do.
* :func:`flash_attention` is differentiable. On a CUDA tensor its forward
  launches ``csrc/flash_fwd.cu`` and its backward the dq and dk/dv kernels
  of ``csrc/flash_bwd.cu`` (in bf16 the forward and dk/dv kernels stream
  their tiles by TMA and multiply with wgmma, ``csrc/sm90.cuh``); on a
  CPU tensor both run the plain versions,
  so the CPU tests exercise the backward arithmetic the card runs. On the
  card it launches the kernels or raises; it never falls back to the plain
  version there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["mha_reference", "flash_attention", "flash_bwd_prep",
           "flash_bwd_dq_reference", "flash_bwd_dkv_reference",
           "flash_fwd_launches", "flash_bwd_dq_launches",
           "flash_bwd_dkv_launches"]

NEG_INF = float("-inf")

#: kernel launches made in this process by the forward and by the two
#: backward kernels (plain counts; callers reset them to 0 to count a run)
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _causal_mask(sq: int, sk: int, q_offset: int, kv_offset: int,
                 device) -> torch.Tensor:
    """(Sq, Sk) bool, True where the key lies in the query's future."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = kv_offset + torch.arange(sk, device=device)[None]
    return kpos > qpos


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, q_offset: int = 0,
                  kv_offset: int = 0, scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention over (..., S, D) with f32 scores; returns (out in
    q's dtype, lse in f32). Fully-masked rows give out 0 and lse -inf."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[-2], k.shape[-2], q_offset,
                                       kv_offset, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(m)
    # exp(-inf - -inf) is guarded by zeroing the fully-masked rows.
    safe_m = torch.where(finite, m, torch.zeros_like(m))
    p = torch.exp(s - safe_m)
    p = torch.where(finite, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p, v.float()) / l
    lse = (safe_m + torch.log(l))[..., 0]
    lse = torch.where(finite[..., 0], lse,
                      torch.full_like(lse, NEG_INF))
    return out.to(q.dtype), lse


def flash_bwd_prep(do: torch.Tensor, out: torch.Tensor,
                   dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``c = rowsum(do * out) - dlse`` in f32, (B, H, Sq) (``attention.py:
    355-357``): the lse cotangent folds into the same term, since
    ``ds = p * (dp - rowsum(do * out) + dlse)``. ``dlse`` None is 0."""
    c = (do.float() * out.float()).sum(dim=-1)
    return c if dlse is None else c - dlse.float()


def _probs(q, k, lse, causal, q_offset, kv_offset, scale):
    """p = exp(s - lse) recomputed in f32, with lse -inf (a fully-masked
    row) taken as 1e30 so that the row's p is exp(-inf - 1e30) = 0
    (``attention.py:245-248``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[-2], k.shape[-2], q_offset,
                                       kv_offset, q.device), NEG_INF)
    safe_lse = torch.where(torch.isfinite(lse), lse,
                           torch.full_like(lse, 1e30))
    return torch.exp(s - safe_lse[..., None])


def flash_bwd_dq_reference(q, k, v, do, lse, c, *, causal=False,
                           q_offset=0, kv_offset=0, scale=None
                           ) -> torch.Tensor:
    """dq of the flash backward (``_bwd_dq_kernel``, ``attention.py:
    213-260``): ``dq = (p * (do v^T - c)) k * scale``, with the ds operand
    rounded to k's dtype before the product, as the kernel rounds it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal, q_offset, kv_offset, scale)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    t = p * (dp - c[..., None].float())
    dq = torch.matmul(t.to(k.dtype).float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, c, *, causal=False,
                            q_offset=0, kv_offset=0, scale=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the flash backward (``_bwd_dkv_kernel``, ``attention.py:
    263-313``): ``dv = p^T do`` with p rounded to do's dtype, and
    ``dk = (p * (do v^T - c))^T q * scale`` with ds rounded to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, causal, q_offset, kv_offset, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    t = p * (dp - c[..., None].float())
    dk = torch.matmul(t.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _fit_block(block: int, s: int) -> int:
    """Largest multiple of 8 that divides ``s`` and is <= ``block``
    (0 if none, i.e. s is not a multiple of 8)."""
    block = min(block, s)
    for b in range(block - block % 8, 7, -8):
        if s % b == 0:
            return b
    return 0


class _FlashAttention(torch.autograd.Function):
    """The ``_flash`` custom_vjp (``attention.py:316-411``): the forward
    saves q, k, v, out and the thin lse; the backward forms c and runs dq
    and dk/dv (kernels on the card, plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_offset, scale):
        if q.device.type == "cpu":
            out, lse = mha_reference(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_offset=kv_offset,
                                     scale=scale)
        else:
            out, lse = _flash_fwd_cuda(q, k, v, causal, q_offset, kv_offset,
                                       scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset,
                       scale=scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        c = flash_bwd_prep(do, out, dlse)
        if q.device.type == "cpu":
            dq = flash_bwd_dq_reference(q, k, v, do, lse, c, **ctx.cfg)
            dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, c, **ctx.cfg)
        else:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, do, lse, c, **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    bwd_blocks: Optional[Tuple[int, int, int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over (B, H, S, D); returns (out, lse).

    Differentiable in q, k and v, through out and lse. Sequence lengths
    must be multiples of 8, as in the reference (callers pad).
    ``block_q``/``block_k`` and ``bwd_blocks`` = (block_q_dq, block_k_dq,
    block_q_dkv, block_k_dkv) are the reference's tile upper bounds and
    are checked the same way, with the same messages. The CUDA kernels
    tile by their own sizes whatever they say (in bf16: forward 192
    query rows at head dim 64 and 128 at 128, by 128 keys; dq 64 by 64;
    dk/dv 128 keys by 64 queries at head dim 64 and 32 at 128; in f32:
    forward 16 by 32, backward 16 by 32 or 16) and mask the ragged last
    tiles themselves. On the card they take bf16 or f32 with head dim 64
    or 128.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if block_q is None:
        block_q = 1024 if sq >= 8192 else 512
    if block_k is None:
        block_k = 1024 if sq >= 8192 else 2048
    if not _fit_block(block_q, sq) or not _fit_block(block_k, sk):
        raise ValueError(f"seq lens ({sq},{sk}) must be multiples of 8 "
                         f"(TPU tile alignment)")
    if bwd_blocks is not None:
        if any(bl < 8 for bl in bwd_blocks):
            raise ValueError(f"bwd_blocks entries must be >= 8 (TPU "
                             f"sublane tile), got {bwd_blocks}")
        bq_dq, bk_dq, bq_dkv, bk_dkv = bwd_blocks
        if not all((_fit_block(bq_dq, sq), _fit_block(bk_dq, sk),
                    _fit_block(bq_dkv, sq), _fit_block(bk_dkv, sk))):
            raise ValueError(f"seq lens ({sq},{sk}) must be multiples of "
                             f"8 (TPU tile alignment)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _FlashAttention.apply(q, k, v, causal, q_offset, kv_offset, scale)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place, else a fresh
    contiguous copy. In place takes what a TMA tensor map takes: a unit
    feature stride, a 16-byte aligned base and every other stride a
    positive multiple of 16 bytes. The (B, H, S, D) views of one fused
    (B, S, 3 * H * D) projection pass. ``contiguous()`` would not do for
    the copy: it returns a contiguous view with a misaligned base as it
    is."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s * t.element_size() % 16 == 0
                  for s in t.stride()[:-1]))
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _check_cuda_inputs(what: str, q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {q.device}; the kernel runs "
                         f"on CUDA and the plain version on the CPU")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{what} kernel takes bf16 or f32 (q, k, v all "
                        f"alike), got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape or \
            not q.device == k.device == v.device:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree (or lie on "
                         f"different devices)")


def _load_fwd() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.flash_fwd.argtypes = ([p] * 5 + [i64] * 12 + [i32] * 7
                                  + [i64, i64, ctypes.c_float, p])
        lib.flash_fwd.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _flash_fwd_cuda(q, k, v, causal, q_offset, kv_offset, scale):
    global flash_fwd_launches
    _check_cuda_inputs("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # out is laid out (B, S, H, D) and returned as its (B, H, S, D) view,
    # so that merging the heads back is free.
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _load_fwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], b, h, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(bool(causal)), int(q_offset),
            int(kv_offset), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err} "
                           f"({lib.flash_fwd_error_string(err).decode()})")
    flash_fwd_launches += 1
    return out, lse


def _load_bwd() -> ctypes.CDLL:
    lib = _build.load("flash_bwd")
    if lib.flash_bwd_dq.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        args = ([p] * 8 + [ctypes.POINTER(i64)] + [i32] * 7
                + [i64, i64, ctypes.c_float, p])
        for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
            fn.argtypes = args
            fn.restype = i32
        lib.flash_bwd_error_string.argtypes = [i32]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, H, S, D) gradient laid out (B, S, H, D), as the
    forward lays out out."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def _bwd_launch(name, q, k, v, do, lse, c, outs, causal, q_offset,
                kv_offset, scale):
    """One launch of ``name`` (flash_bwd_dq or flash_bwd_dkv) on the
    current stream, writing ``outs``; raises on a CUDA error."""
    _check_cuda_inputs("flash_attention backward", q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention backward: do {tuple(do.shape)} "
                         f"{do.dtype} does not match q {tuple(q.shape)} "
                         f"{q.dtype}")
    b, h, sq, d = q.shape
    lib = _load_bwd()
    strides = [s for t in (q, k, v, do) + outs
               for s in (t.stride()[:3] if t is not None else (0, 0, 0))]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), c.data_ptr(), outs[0].data_ptr(),
            None if outs[1] is None else outs[1].data_ptr(),
            (ctypes.c_longlong * len(strides))(*strides), b, h, sq,
            k.shape[2], d, _DTYPE_CODES[q.dtype], int(bool(causal)),
            int(q_offset), int(kv_offset), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.flash_bwd_error_string(err).decode()})")


def _bwd_operands(q, k, v, do, lse, c):
    """The operands as the kernels read them: q, k, v, do as
    :func:`_aligned` leaves them, lse and c contiguous f32 with 16-byte
    aligned bases."""
    return (_aligned(q), _aligned(k), _aligned(v), _aligned(do),
            _aligned_rows(lse), _aligned_rows(c))


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """An f32 (B, H, S) tensor contiguous with a 16-byte aligned base, as
    the dk/dv kernel's TMA reads lse and c (a copy where needed)."""
    t = t.float()
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _flash_bwd_dq_cuda(q, k, v, do, lse, c, *, causal, q_offset, kv_offset,
                       scale):
    """dq by the dq kernel (one launch); (B, H, Sq, D) in q's dtype."""
    global flash_bwd_dq_launches
    q, k, v, do, lse, c = _bwd_operands(q, k, v, do, lse, c)
    dq = _grad_like(q)
    _bwd_launch("flash_bwd_dq", q, k, v, do, lse, c, (dq, None), causal,
                q_offset, kv_offset, scale)
    flash_bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, c, *, causal, q_offset,
                        kv_offset, scale):
    """(dk, dv) by the dk/dv kernel (one launch), in k's dtype."""
    global flash_bwd_dkv_launches
    q, k, v, do, lse, c = _bwd_operands(q, k, v, do, lse, c)
    dk, dv = _grad_like(k), _grad_like(v)
    _bwd_launch("flash_bwd_dkv", q, k, v, do, lse, c, (dk, dv), causal,
                q_offset, kv_offset, scale)
    flash_bwd_dkv_launches += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, c, **cfg):
    """The dq kernel, then the dk/dv kernel, on the current stream;
    returns (dq, dk, dv) in the input dtype."""
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, c, **cfg)
    return (dq,) + _flash_bwd_dkv_cuda(q, k, v, do, lse, c, **cfg)
