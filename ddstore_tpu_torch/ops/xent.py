"""Fused linear + softmax cross-entropy, forward and backward (the port of
``ddstore_tpu/ops/xent.py:58-159``).

Computes the per-token negative log-likelihood of ``softmax(x @ w)`` by
streaming the vocabulary in blocks through an online logsumexp, so the
``(tokens, vocab)`` logits never exist at once: peak memory is
``(tokens, block)``. The backward recomputes each vocab block's logits
from the saved ``x``, ``w`` and the per-token lse, as the reference's
custom VJP does. The reference has no Pallas kernel here (its scan is
plain XLA), so this is plain PyTorch with ``torch.matmul``.

Where the vocabulary is not a multiple of the block, the last block is
the narrower slice of the remaining columns. The reference pads ``w`` to
whole blocks and masks the padded columns to -inf (``_pad_cols``,
``_logits_block``), so that they add nothing to the lse and get p = 0 in
the backward; a slice without those columns gives the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.profile import annotate

__all__ = ["fused_linear_xent"]


def _blocks(v: int, block: int):
    """(lo, hi) column ranges of the vocab blocks, the last one ragged."""
    return [(lo, min(lo + block, v)) for lo in range(0, v, block)]


class _FusedLinearXent(torch.autograd.Function):
    """``fused_linear_xent``'s custom VJP (``xent.py:92-159``): the forward
    saves x, w, targets and the per-token lse; the backward recomputes
    each block's logits and never builds the ``(tokens, vocab)`` ones."""

    @staticmethod
    @annotate("ddstore:head_fwd")
    def forward(ctx, x, w, targets, block, compute_dtype):
        dt = compute_dtype or x.dtype
        n = x.shape[0]
        v = w.shape[1]
        # Operands rounded to the compute dtype, products summed in f32.
        xc = x.to(dt).float()
        rows = torch.arange(n, device=x.device)
        targets = targets.reshape(-1).long()
        m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
        l = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tl = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for lo, hi in _blocks(v, block):
            lg = torch.matmul(xc, w[:, lo:hi].to(dt).float())
            m_new = torch.maximum(m, lg.amax(dim=-1))
            l = l * torch.exp(m - m_new) + \
                torch.exp(lg - m_new[:, None]).sum(-1)
            m = m_new
            t_local = targets - lo
            in_blk = (t_local >= 0) & (t_local < hi - lo)
            picked = lg[rows, t_local.clamp(0, hi - lo - 1)]
            tl = torch.where(in_blk, picked, tl)
        lse = m + torch.log(l)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.cfg = (block, dt)
        return lse - tl

    @staticmethod
    @annotate("ddstore:head_bwd")
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        block, dt = ctx.cfg
        n, d = x.shape
        v = w.shape[1]
        xc = x.to(dt).float()
        gcol = g.float()[:, None]
        dx = torch.zeros((n, d), dtype=torch.float32, device=x.device)
        dw = torch.empty((d, v), dtype=torch.float32, device=x.device)
        for lo, hi in _blocks(v, block):
            wb = w[:, lo:hi].to(dt).float()
            lg = torch.matmul(xc, wb)
            p = torch.exp(lg - lse[:, None])  # the softmax block
            t_local = targets - lo
            in_blk = (t_local >= 0) & (t_local < hi - lo)
            # minus the one-hot of the targets that fall in this block
            p.scatter_add_(1, t_local.clamp(0, hi - lo - 1)[:, None],
                           -in_blk.float()[:, None])
            dlg = (p * gcol).to(dt).float()
            dx += torch.matmul(dlg, wb.t())
            dw[:, lo:hi] = torch.matmul(xc.t(), dlg)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def fused_linear_xent(x: torch.Tensor, w: torch.Tensor,
                      targets: torch.Tensor, block: int = 8192,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Per-token NLL of ``softmax(x @ w)`` without materializing logits.

    x: ``(n, d)`` activations; w: ``(d, v)`` head kernel; targets: ``(n,)``
    class ids in ``[0, v)``. The matmul operands are cast to
    ``compute_dtype`` (default ``x.dtype``) and the products accumulate in
    f32, as the reference's ``preferred_element_type=f32``. Returns
    ``(n,)`` f32; ``nll.mean()`` equals the unfused loss up to summation
    order. Differentiable in ``x`` (``dx`` in x's dtype) and ``w`` (``dw``
    in w's dtype).
    """
    return _FusedLinearXent.apply(x, w, targets, min(block, w.shape[1]),
                                  compute_dtype)
