"""Attention: the flash-attention forward kernel and its plain version.

The port of ``ddstore_tpu/ops/attention.py`` (forward only). Both
functions take (B, H, S, D) tensors and return ``(out, lse)``, where
``lse`` is the per-query log-sum-exp of the scores in f32, (B, H, S).

* :func:`mha_reference` is the plain PyTorch version (``attention.py:
  64-89``): it materializes the scores, and is what the CPU runs.
* :func:`flash_attention` launches the hand-written CUDA kernel
  ``csrc/flash_fwd.cu`` on a CUDA tensor and calls :func:`mha_reference`
  on a CPU tensor. On the card it launches the kernel or raises; it never
  falls back to the plain version there.

The backward kernels come with training; until then a call that needs a
gradient raises instead of differentiating the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["mha_reference", "flash_attention", "flash_fwd_launches"]

NEG_INF = float("-inf")

#: kernel launches made by :func:`flash_attention` in this process (a plain
#: count; callers reset it to 0 to count one run)
flash_fwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


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
        qpos = q_offset + torch.arange(q.shape[-2], device=q.device)[:, None]
        kpos = kv_offset + torch.arange(k.shape[-2], device=q.device)[None]
        s = s.masked_fill(kpos > qpos, NEG_INF)
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


def _fit_block(block: int, s: int) -> int:
    """Largest multiple of 8 that divides ``s`` and is <= ``block``
    (0 if none, i.e. s is not a multiple of 8)."""
    block = min(block, s)
    for b in range(block - block % 8, 7, -8):
        if s % b == 0:
            return b
    return 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, q_offset: int = 0,
                    kv_offset: int = 0, scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over (B, H, S, D); returns (out, lse).

    Sequence lengths must be multiples of 8, as in the reference (callers
    pad). ``block_q``/``block_k`` are the reference's tile upper bounds
    and are checked the same way; the CUDA kernel tiles at 64 query rows
    by 64 keys (bf16) or 16 by 32 (f32) whatever they say, and masks the
    ragged last tile itself. On the card it takes bf16 or f32 with head
    dim 64 or 128.
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash backward: slice 2")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset, scale=scale)
    return _flash_fwd_cuda(q, k, v, causal, q_offset, kv_offset, scale)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (unit feature
    stride, 16-byte aligned rows), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _load_kernel() -> ctypes.CDLL:
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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device}; the "
                         f"kernel runs on CUDA and the plain version on "
                         f"the CPU")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or f32 "
                        f"(q, k, v all alike), got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{_HEAD_DIMS}, got {d}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape or \
            not q.device == k.device == v.device:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"agree (or lie on different devices)")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    # out is laid out (B, S, H, D) and returned as its (B, H, S, D) view,
    # so that merging the heads back is free.
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _load_kernel()
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
