"""Ring attention: exact attention over a sequence-parallel process group
(the port of ``ddstore_tpu/parallel/ring_attention.py``).

Q, K and V are sharded along the sequence over the mesh's ``sp`` axis:
each rank holds its ``(B, H, S/n, D)`` chunk of each, keeps its Q chunk,
and passes the K/V chunks round the ring, one neighbour a step. After
``step`` shifts a rank holds the chunk of rank ``(idx - step) % n``; it
attends to it with global offsets, and the per-step partials ``(out_i,
lse_i)`` merge with the online-softmax algebra flash attention uses
across key blocks (:func:`_combine`), so the result is exact attention
over the whole sequence. Under a causal mask a chunk entirely in the
query chunk's future is not launched (out 0, lse -inf): rank ``idx`` runs
``idx + 1`` of its ``n`` steps.

Each live step's forward is :func:`~ddstore_tpu_torch.ops.attention.
flash_attention` with ``q_offset = idx * S/n`` and ``kv_offset = src *
S/n``: the forward kernel on the card. The shift is one
``batch_isend_irecv`` of K and V packed into one buffer. The whole ring
is one autograd function, :class:`_Ring`. Its backward runs the dq and
dk/dv kernels of each live step on the caller's ``do`` with the final
lse and one ``c = rowsum(do * out) - dlse``, as a flash backward does
across key blocks, and sends each chunk's gradient back the way the chunk
came. This departs from the reference, whose ``jax.grad`` goes through
``_combine`` and hands each step's bf16 partial out a cotangent ``w_i *
do`` rounded to bf16: the port's bf16 dk rows of keys near the sequence
end keep one whole-sequence call's precision (``ROADMAP.md`` C). The two
agree in f32.

Every shift, forward or backward, is a collective of the ``sp`` group.
The order of the p2p operations is the same on every rank: the forward
runs its ``n - 1`` shifts in step order, and the backward runs ``n - 1``
shifts in the reverse order on every rank, a rank whose own gradient for
a chunk is 0 included. Forward and backward shifts carry distinct tags,
so a forward shift that a rematerialized block replays inside the
backward can never be matched with a peer's backward shift of the same
shape.

Over gloo, CUDA tensors cross through pinned host buffers (gloo's send
and receive take host memory); NCCL takes them as they are.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import (_flash_bwd_cuda, flash_attention,
                             flash_bwd_dkv_reference, flash_bwd_dq_reference,
                             flash_bwd_prep, mha_reference)
from .mesh import axis_index, axis_size

__all__ = ["ring_attention", "ring_self_attention", "ring_shift_stats"]

_FWD_TAG, _BWD_TAG = 0x5200, 0x5300  # + step: forward and backward shifts

#: shifts made in this process (forward, backward) and their bytes; plain
#: counts that callers reset to measure a run
ring_shift_stats = {"forward": 0, "backward": 0, "bytes": 0}


def _combine(acc_out, acc_lse, out_i, lse_i):
    """Merge two normalized attention partials (f32 math), as
    ``ring_attention.py:40-50``: -inf-safe, ``denom`` floored at 1e-30,
    lse -inf where both partials are."""
    m = torch.maximum(acc_lse, lse_i)
    fin = torch.isfinite(m)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    safe_m = torch.where(fin, m, zero)
    w1 = torch.where(torch.isfinite(acc_lse), torch.exp(acc_lse - safe_m),
                     zero)
    w2 = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - safe_m), zero)
    denom = torch.maximum(w1 + w2, torch.full((), 1e-30, device=m.device))
    out = (acc_out * w1[..., None] + out_i.float() * w2[..., None]) \
        / denom[..., None]
    lse = torch.where(fin, safe_m + torch.log(denom),
                      torch.full((), float("-inf"), device=m.device))
    return out, lse


def _shift(t: torch.Tensor, group, n: int, idx: int, direction: int,
           tag: int) -> torch.Tensor:
    """Send ``t`` to the rank ``direction`` steps round the ring and
    receive the same shape from the rank as far the other way (group
    positions, mod ``n``)."""
    send = t.contiguous()
    dst = dist.get_global_rank(group, (idx + direction) % n)
    src = dist.get_global_rank(group, (idx - direction) % n)
    staged = send.is_cuda and \
        str(dist.get_backend(group)).lower() == "gloo"
    if staged:
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        recv = torch.empty_like(host, pin_memory=True)
        ops = [dist.P2POp(dist.isend, host, dst, group, tag),
               dist.P2POp(dist.irecv, recv, src, group, tag)]
    else:
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, dst, group, tag),
               dist.P2POp(dist.irecv, recv, src, group, tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    ring_shift_stats["bytes"] += send.numel() * send.element_size()
    return recv.to(t.device) if staged else recv


class _Ring(torch.autograd.Function):
    """The ring on this rank's chunks (``ring_attention.py:53-115``), one
    function from ``(q, k, v)`` to ``(out, lse)``.

    The forward attends to each live step's chunk with ``attend(q, k, v,
    q_offset, kv_offset) -> (out_i, lse_i)``, merges the partials with
    :func:`_combine` and runs the ``n - 1`` shifts of the packed K/V in
    step order. It saves q, the chunks the live steps read, and the final
    out and lse: no per-step partial.

    The backward forms ``c = rowsum(do * out) - dlse`` once and runs
    ``grads(q, k, v, do, lse, c, q_offset=, kv_offset=) -> (dq, dk, dv)``
    on each live step's chunk with the final lse and c: the gradient of
    the whole row's softmax, so no step's share of ``do`` is rounded on
    its own. dq sums over the steps in f32. Each chunk's (dk, dv) goes
    back round the ring to its owner packed in the chunk's dtype, one
    backward shift for each forward shift in reverse order, on every rank:
    a rank that read a chunk in no live step passes on a zero share."""

    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, attend, grads):
        sq, sk = q.shape[2], k.shape[2]
        acc_out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc_lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                             device=q.device)
        kv: Optional[torch.Tensor] = None
        live, received = [], []
        for step in range(n):
            src = (idx - step) % n
            kk, vv = (k, v) if kv is None else (kv[0], kv[1])
            # A chunk entirely in the query chunk's future is fully masked:
            # out 0 and lse -inf, which _combine leaves the running pair
            # exactly as it is, so the step is skipped.
            if not causal or src <= idx:
                out_i, lse_i = attend(q, kk, vv, idx * sq, src * sk)
                acc_out, acc_lse = _combine(acc_out, acc_lse, out_i, lse_i)
                live.append(step)
                if kv is not None:
                    received.append(kv)
            if step < n - 1:
                packed = torch.stack((k, v)) if kv is None else kv
                ring_shift_stats["forward"] += 1
                kv = _shift(packed, group, n, idx, 1, _FWD_TAG + step)
        out = acc_out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, acc_lse, *received)
        ctx.ring = (group, n, idx, live, grads)
        ctx.set_materialize_grads(False)
        return out, acc_lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, *received = ctx.saved_tensors
        group, n, idx, live, grads = ctx.ring
        sq, sk = q.shape[2], k.shape[2]
        if do is None:
            do = torch.zeros_like(out)
        c = flash_bwd_prep(do, out, dlse)
        # step 0 reads this rank's own chunk, and is always live
        chunks = dict(zip(live, [(k, v)] + [(t[0], t[1]) for t in received]))
        dq = g = None
        for step in reversed(range(n)):
            if step < n - 1:
                # g is the gradient of the chunk that forward shift `step`
                # brought: it goes back to the rank it came from
                ring_shift_stats["backward"] += 1
                g = _shift(g, group, n, idx, -1, _BWD_TAG + step)
            if step in chunks:
                kk, vv = chunks[step]
                dq_i, dk_i, dv_i = grads(q, kk, vv, do, lse, c,
                                         q_offset=idx * sq,
                                         kv_offset=(idx - step) % n * sk)
                dq = dq_i.float() if dq is None else dq + dq_i.float()
                dkv = torch.stack((dk_i, dv_i))
                g = dkv if g is None else g + dkv
            elif g is None:
                g = torch.zeros((2,) + tuple(k.shape), dtype=k.dtype,
                                device=k.device)
        return dq.to(q.dtype), g[0], g[1], None, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis: str = "sp", causal: bool = False,
                   batch_axis: Optional[str] = None,
                   heads_axis: Optional[str] = None, impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention over (B, H, S, D) with S sharded over ``axis``.

    ``q``, ``k`` and ``v`` are this rank's chunk: ``(B_local, H_local,
    S/n, D)``, the sequence positions ``[i * S/n, (i + 1) * S/n)`` for
    the rank's position ``i`` along ``axis``. ``batch_axis`` and
    ``heads_axis`` name the mesh axes that B and H are split over (the
    reference's ``P(batch_axis, heads_axis, axis)``); the chunks are
    already local, so they only record the layout: the ring runs over
    ``mesh.get_group(axis)`` alone. Returns ``(out, lse)``: out in q's
    dtype, lse f32 (B_local, H_local, S/n). Differentiable in q, k and v.
    A collective: every rank of the axis calls it, in the same order.

    ``impl``: ``"flash"`` is :func:`~ddstore_tpu_torch.ops.attention.
    flash_attention` per step (the kernels on the card, their plain
    versions on the CPU), and needs equal chunks that are multiples of 8;
    ``"xla"`` is the plain ``mha_reference`` with offsets; ``"auto"`` is
    ``"flash"`` on the card (where a chunk that is not a multiple of 8
    raises ``ValueError``) and on the CPU where the chunks allow it, else
    ``"xla"``.
    """
    del batch_axis, heads_axis  # layout only: the chunks are local
    n = axis_size(mesh, axis)
    sq, sk = q.shape[2], k.shape[2]
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown impl: {impl!r}")
    use_flash = impl == "flash" or impl == "auto" and (
        q.device.type != "cpu" or (sq == sk and sq % 8 == 0))
    if use_flash and (sq != sk or sq % 8):
        raise ValueError(f"impl='flash' needs equal tile-aligned "
                         f"chunks, got ({sq},{sk})")
    fn = flash_attention if use_flash else mha_reference
    scale = 1.0 / math.sqrt(q.shape[-1])

    def attend(qq, kk, vv, q_off, kv_off):
        return fn(qq, kk, vv, causal=causal, q_offset=q_off,
                  kv_offset=kv_off)

    def grads(qq, kk, vv, do, lse, c, **offsets):
        cfg = dict(causal=causal, scale=scale, **offsets)
        if use_flash and qq.device.type != "cpu":
            return _flash_bwd_cuda(qq, kk, vv, do, lse, c, **cfg)
        return (flash_bwd_dq_reference(qq, kk, vv, do, lse, c, **cfg),) + \
            flash_bwd_dkv_reference(qq, kk, vv, do, lse, c, **cfg)

    if n == 1:
        return attend(q, k, v, 0, 0)
    return _Ring.apply(q, k, v, mesh.get_group(axis), n,
                       axis_index(mesh, axis), causal, attend, grads)


def ring_self_attention(x_heads: torch.Tensor, *, mesh, axis: str = "sp",
                        causal: bool = True) -> torch.Tensor:
    """Convenience: q = k = v = x_heads (B, H, S/n, D); returns out only."""
    out, _ = ring_attention(x_heads, x_heads, x_heads, mesh=mesh, axis=axis,
                            causal=causal)
    return out
