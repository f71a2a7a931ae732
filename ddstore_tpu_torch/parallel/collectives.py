"""The collectives of the model-parallel layers, and their autograd forms.

Tensor, expert and fully-sharded parallelism (``tp.py``, ``moe.py``,
``fsdp.py``) exchange activations and gradients over the groups of a
:func:`~ddstore_tpu_torch.parallel.mesh.make_mesh` mesh. Two ranks that
share one card run over gloo (NCCL refuses them), and gloo takes a CUDA
tensor in ``all_reduce`` and ``all_gather`` but not in every collective:
:data:`HOST_STAGED` names the ones whose CUDA tensors cross through pinned
host buffers over gloo, as the ring's shifts do. NCCL takes them all as
they are.

The autograd functions are Megatron's pair: :func:`copy_to_group` is the
identity forward whose backward sums the gradient over the group (the
input of a column-parallel product, or of the local experts), and
:func:`reduce_from_group` sums over the group forward and passes the
gradient through (the partial output of a row-parallel product, or of the
local experts). :func:`all_gather_counts` gathers a small integer tensor
from every rank of a group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["HOST_STAGED", "staged", "all_reduce", "all_gather_into",
           "reduce_scatter", "copy_to_group", "reduce_from_group",
           "all_gather_counts", "group_size", "collective_stats"]

#: collectives whose CUDA tensors gloo refuses: they go through host memory
HOST_STAGED = frozenset({"all_gather_into_tensor", "reduce_scatter_tensor"})

#: calls and bytes of each collective of this module made in this process;
#: plain counts that callers reset to measure a run
collective_stats = {"calls": 0, "bytes": 0}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def staged(t: torch.Tensor, group, op: str) -> bool:
    """Whether ``op`` on ``t`` over ``group`` crosses through host memory."""
    return (t.is_cuda and op in HOST_STAGED
            and str(dist.get_backend(group)).lower() == "gloo")


def _count(t: torch.Tensor) -> None:
    collective_stats["calls"] += 1
    collective_stats["bytes"] += t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` in place; returns ``t``."""
    if group_size(group) > 1:
        _count(t)
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group
                    ) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 into ``out``."""
    _count(t)
    if staged(t, group, "all_gather_into_tensor"):
        h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(h, _host(t), group=group)
        out.copy_(h, non_blocking=False)
    else:
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` summed over ``group``; this rank's dim-0 block into ``out``."""
    _count(t)
    if staged(t, group, "reduce_scatter_tensor"):
        h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(h, _host(t), op=op, group=group)
        out.copy_(h, non_blocking=False)
    else:
        dist.reduce_scatter_tensor(out, t.contiguous(), op=op, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group``."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passes through."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def all_gather_counts(t: torch.Tensor, group: Optional[object]
                      ) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` of ``group``, in rank order."""
    n = group_size(group)
    if n == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(n)]
    _count(t)
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)
