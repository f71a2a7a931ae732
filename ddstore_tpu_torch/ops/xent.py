"""Fused linear + softmax cross-entropy, forward only (the port of
``ddstore_tpu/ops/xent.py:58`` onward).

Computes the per-token negative log-likelihood of ``softmax(x @ w)`` by
streaming the vocabulary in blocks through an online logsumexp, so the
``(tokens, vocab)`` logits never exist at once: peak memory is
``(tokens, block)``. The reference has no Pallas kernel here (its scan is
plain XLA), so this is plain PyTorch with ``torch.matmul``. The backward
comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["fused_linear_xent"]


@torch.no_grad()
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
    order.
    """
    dt = compute_dtype or x.dtype
    n = x.shape[0]
    v = w.shape[1]
    block = min(block, v)
    # Operands rounded to the compute dtype, products summed in f32.
    xc = x.to(dt).float()
    rows = torch.arange(n, device=x.device)
    targets = targets.reshape(-1).long()
    m = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x.device)
    tl = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for lo in range(0, v, block):
        lg = torch.matmul(xc, w[:, lo:lo + block].to(dt).float())
        m_new = torch.maximum(m, lg.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(-1)
        m = m_new
        t_local = targets - lo
        in_blk = (t_local >= 0) & (t_local < lg.shape[1])
        picked = lg[rows, t_local.clamp(0, lg.shape[1] - 1)]
        tl = torch.where(in_blk, picked, tl)
    return m + torch.log(l) - tl
