"""The held-expert layer's row passes (``csrc/held_rows.cu``) and their
plain versions.

:class:`~ddstore_tpu_torch.models.moe.RoutedExperts` runs its held
assignments through buffers of a fixed number of rows, ``tokens x
min(top_k, held experts)`` (the most a dropless layer can send to this
rank), whose first ``n`` rows hold the assignments in expert order; ``n``
is ``offs[-1]``, the last of the grouped products' offsets, and stays on
the device, so that the step never waits on the host for it. Rows past
``n`` are never written or read: a buffer comes from ``torch.empty``.
``pos`` (tokens, top_k) int64 is each choice's row, -1 for an expert this
rank does not hold.

* :func:`scatter_rows`: each token's input into the rows of its held
  choices;
* :func:`combine`: each token's sum of its held rows times their gates
  (or 1), in f32;
* :func:`combine_bwd`: the rows' cotangent (the token's times the gate)
  and each gate's (the token's cotangent dotted with its row);
* :func:`swiglu_rows`, :func:`swiglu_bwd`: ``silu(gate) * up`` of the
  first n rows of ``[gate | up]``, and its backward.

On a CUDA tensor each launches its kernel (bf16 only, top_k at most 16,
widths multiples of 8) or raises; on a CPU tensor each runs its plain
version, which reads ``n`` on the host. There is no counterpart in the JAX
package, which has no held-expert layer. What bounds the kernels and how
they are built: the source's head comment.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["scatter_rows", "combine", "combine_bwd", "swiglu_rows",
           "swiglu_bwd", "held_launches"]

#: kernel launches made in this process by the five row passes (a plain
#: count; callers read differences)
held_launches = 0

_MAX_TOP_K = 16


def _lib() -> ctypes.CDLL:
    lib = _build.load("held_rows")
    if lib.held_scatter.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args in (("held_scatter", [p, p, p, i32, i32, i32, p]),
                           ("held_combine",
                            [p, p, p, p, i32, i32, i32, i32, p]),
                           ("held_combine_bwd",
                            [p] * 6 + [i32, i32, i32, p]),
                           ("held_swiglu", [p, p, i32, p, i32, p]),
                           ("held_swiglu_bwd", [p, p, p, i32, p, i32, p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i32
        lib.held_rows_error_string.argtypes = [i32]
        lib.held_rows_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, device: torch.device, *args) -> None:
    """One launch of entry ``name`` on ``device``'s current stream (tensors
    passed by pointer, None as a null one); raises on its error."""
    global held_launches
    lib = _lib()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*ptrs, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.held_rows_error_string(err).decode()})")
    held_launches += 1


def _check(*ts: torch.Tensor, k: int = 1) -> None:
    """The kernels' terms: contiguous rows whose width is a multiple of 8,
    top_k at most 16."""
    for t in ts:
        if not t.is_contiguous() or t.shape[-1] % 8:
            raise ValueError(f"the held-expert kernels take contiguous rows "
                             f"whose width is a multiple of 8, got "
                             f"{tuple(t.shape)}")
    if not 1 <= k <= _MAX_TOP_K:
        raise ValueError(f"the held-expert kernels take top_k up to "
                         f"{_MAX_TOP_K}, got {k}")


def _bf16(t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"the held-expert kernels compute in bf16 on the "
                         f"card, got {t.dtype}")


def _rows_of(pos: torch.Tensor) -> torch.Tensor:
    """``pos`` as the kernels read it: int64, contiguous."""
    if pos.dtype != torch.int64:
        raise ValueError(f"pos must be int64, got {pos.dtype}")
    return pos.contiguous()


def _offsets(offs: torch.Tensor) -> torch.Tensor:
    """``offs`` as the kernels read it: int32, contiguous."""
    if offs.dtype != torch.int32:
        raise ValueError(f"offs must be int32, got {offs.dtype}")
    return offs.contiguous()


def _held(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the token of each held choice, its row), in (token, choice) order:
    the plain versions' index."""
    valid = pos >= 0
    return valid.nonzero(as_tuple=True)[0], pos[valid]


def scatter_rows(x: torch.Tensor, pos: torch.Tensor, rows: int
                 ) -> torch.Tensor:
    """(rows, d) in x's dtype: row ``pos[t, j]`` is ``x[t]`` for every held
    choice; the rest unwritten."""
    t, d = x.shape
    xs = torch.empty(rows, d, dtype=x.dtype, device=x.device)
    if x.is_cuda:
        _bf16(x)
        _check(x, k=pos.shape[1])
        _launch("held_scatter", x.device, x, _rows_of(pos), xs, t,
                pos.shape[1], d)
        return xs
    tok, row = _held(pos)
    xs[row] = x[tok]
    return xs


def combine(ys: torch.Tensor, pos: torch.Tensor,
            gates: Optional[torch.Tensor], dtype: torch.dtype
            ) -> torch.Tensor:
    """(tokens, d) in ``dtype``: each token's sum over its held choices of
    ``gates[t, j] * ys[pos[t, j]]`` (gate 1 where ``gates`` is None),
    summed in f32."""
    t, k = pos.shape
    d = ys.shape[1]
    if ys.is_cuda:
        _bf16(ys)
        _check(ys, k=k)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"combine stores f32 or bf16, got {dtype}")
        out = torch.empty(t, d, dtype=dtype, device=ys.device)
        _launch("held_combine", ys.device, ys, _rows_of(pos),
                None if gates is None else gates.float().contiguous(), out,
                int(dtype == torch.float32), t, k, d)
        return out
    tok, row = _held(pos)
    part = ys[row].float()
    if gates is not None:
        part = part * gates[pos >= 0].float()[:, None]
    out = torch.zeros(t, d, dtype=torch.float32, device=ys.device)
    return out.index_add_(0, tok, part).to(dtype)


def combine_bwd(dy: torch.Tensor, ys: torch.Tensor, pos: torch.Tensor,
                gates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`combine` with gates, from the f32 cotangent
    ``dy`` (tokens, d): (the rows' cotangent, ys's shape and dtype, rows
    of no held choice unwritten; the gates' (tokens, top_k) f32, 0 where
    not held)."""
    t, k = pos.shape
    d = ys.shape[1]
    dys = torch.empty_like(ys)
    if ys.is_cuda:
        _bf16(ys)
        dy = dy.float().contiguous()
        _check(dy, ys, k=k)
        dgates = torch.empty(t, k, dtype=torch.float32, device=ys.device)
        _launch("held_combine_bwd", ys.device, dy, ys, _rows_of(pos),
                gates.float().contiguous(), dys, dgates, t, k, d)
        return dys, dgates
    tok, row = _held(pos)
    held = pos >= 0
    dyt = dy[tok].float()
    dys[row] = (dyt * gates[held].float()[:, None]).to(ys.dtype)
    dgates = torch.zeros(t, k, dtype=torch.float32, device=ys.device)
    dgates[held] = (dyt * ys[row].float()).sum(-1)
    return dys, dgates


def swiglu_rows(gu: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(rows, h): ``silu(gate) * up`` of the first ``offs[-1]`` rows of
    ``gu`` = [gate | up] (rows, 2h), in f32, stored in gu's dtype."""
    rows, h = gu.shape[0], gu.shape[1] // 2
    act = torch.empty(rows, h, dtype=gu.dtype, device=gu.device)
    if gu.is_cuda:
        _bf16(gu)
        _check(gu, act)
        _launch("held_swiglu", gu.device, gu, _offsets(offs),
                offs.numel(), act, h)
        return act
    n = int(offs[-1]) if offs.numel() else 0
    g, u = gu[:n].float().chunk(2, dim=-1)
    act[:n] = (F.silu(g) * u).to(gu.dtype)
    return act


def swiglu_bwd(gu: torch.Tensor, da: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """The cotangent of ``gu`` (rows, 2h) from that of :func:`swiglu_rows`'s
    output ``da`` (rows, h), on the first ``offs[-1]`` rows, in f32,
    stored in gu's dtype."""
    h = gu.shape[1] // 2
    dgu = torch.empty_like(gu)
    if gu.is_cuda:
        _bf16(gu)
        _bf16(da)
        _check(gu, da)
        _launch("held_swiglu_bwd", gu.device, gu, da, _offsets(offs),
                offs.numel(), dgu, h)
        return dgu
    n = int(offs[-1]) if offs.numel() else 0
    g, u = gu[:n].float().chunk(2, dim=-1)
    a = da[:n].float()
    s = torch.sigmoid(g)
    dgu[:n] = torch.cat([a * u * s * (1 + g * (1 - s)), a * g * s],
                        dim=-1).to(gu.dtype)
    return dgu
