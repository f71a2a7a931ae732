"""Fully-sharded data parallelism (ZeRO-3) with FSDP2 (the port of
``ddstore_tpu/parallel/fsdp.py:35-148``).

The reference shards every parameter over the ``fsdp`` mesh axis by rules
and lets GSPMD gather each layer's parameters before its compute and
reduce-scatter the gradients. Here the same rules pick, per parameter,
the dim FSDP2's ``fully_shard`` shards (``shard_placement_fn``): the
largest dim divisible by the axis size (:func:`fsdp_rules`), with the LM
head kernel sharded on its feature dim so the vocab stays whole
(:func:`_lmhead_feature_spec`), and, on top of tensor or expert
placements, the largest dim they left whole (:func:`fsdp_compose`). A
parameter with no such dim is left out of FSDP (replicated, as the
reference replicates it) and the train step reduces its gradient. The
rules take flax paths and shapes, as the reference's do;
:func:`~ddstore_tpu_torch.parallel.tp.torch_spec` reads them for a torch
parameter.

With a ``dp`` axis too, FSDP2 runs hybrid: parameters sharded over
``fsdp`` and replicated over ``dp`` (the reference's ``P(..., "fsdp")``
on a ``dp x fsdp`` mesh), the gradient reduce-scattered over ``fsdp`` and
all-reduced over ``dp``. FSDP2 divides the reduced gradient by the data
ranks by default, which is the LM's mean; the VAE and GNN sum, as the
reference's losses do, so their placement sets the divide factor to 1.

Over gloo (two ranks on one card), FSDP2's all-gather and reduce-scatter
of CUDA tensors cross through pinned host buffers
(:class:`HostAllGather`, :class:`HostReduceScatter`).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from .collectives import all_gather_into, reduce_scatter, staged
from .mesh import axis_size
from .tp import shard_pytree, torch_spec

__all__ = ["fsdp_rules", "fsdp_compose", "place_zero3", "data_axes",
           "fsdp_mesh", "HostAllGather", "HostReduceScatter"]


def _lmhead_feature_spec(path, shape, size: int, axis: str):
    """The keep-vocab-whole rule for the LM head kernel, shared by
    :func:`fsdp_rules` and :func:`fsdp_compose`: its feature dim over
    ``axis`` (replicated when it does not divide), never the vocab dim.
    None when the leaf is not the head kernel."""
    if "lmhead" in set(path) and tuple(path[-2:]) == ("head", "kernel") \
            and len(shape) == 2:
        return (axis, None) if shape[0] % size == 0 else ()
    return None


def fsdp_rules(mesh, axis: str = "fsdp") -> Callable:
    """Each leaf sharded over ``axis`` along its largest dim divisible by
    the axis size (the first of equal ones, in flax order); leaves with
    none are replicated."""
    size = axis_size(mesh, axis)

    def rules(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return ()
        head = _lmhead_feature_spec(path, shape, size, axis)
        if head is not None:
            return head
        best = None
        for i, d in enumerate(shape):
            if d % size == 0 and d >= size:
                if best is None or d > shape[best]:
                    best = i
        if best is None:
            return ()
        spec = [None] * len(shape)
        spec[best] = axis
        return tuple(spec)

    return rules


def fsdp_compose(base_rules: Optional[Callable], mesh,
                 axis: str = "fsdp") -> Callable:
    """ZeRO-3 on top of another rule set (fsdp x tp, fsdp x ep): the
    base spec, then ``axis`` on the largest dim it left whole that the
    axis size divides; the head kernel keeps its feature-dim rule where
    the base left it whole."""
    size = axis_size(mesh, axis)

    def rules(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        base = tuple(base_rules(path, leaf)) if base_rules else ()
        spec = list(base) + [None] * (len(shape) - len(base))
        if all(s is None for s in spec):
            head = _lmhead_feature_spec(path, shape, size, axis)
            if head is not None:
                return head
        best = None
        for i, d in enumerate(shape):
            if spec[i] is None and d % size == 0 and d >= size:
                if best is None or d > shape[best]:
                    best = i
        if best is not None:
            spec[best] = axis
        return tuple(spec)

    return rules


def data_axes(mesh, axis: str = "dp") -> Optional[Tuple[str, ...]]:
    """The batch's mesh axes: ``axis`` and ``fsdp`` where larger than 1
    (under ZeRO the batch shards over both); None when neither is."""
    return tuple(a for a in (axis, "fsdp")
                 if axis_size(mesh, a) > 1) or None


def fsdp_mesh(mesh, axis: str = "fsdp", replicate_axis: str = "dp"):
    """The mesh FSDP2 shards over: ``axis``, or ``(replicate_axis,
    axis)`` (hybrid) when ``replicate_axis`` is larger than 1."""
    if axis_size(mesh, replicate_axis) > 1:
        return mesh[(replicate_axis, axis)]
    return mesh[axis]


class HostAllGather:
    """FSDP2's all-gather through host memory where gloo refuses the CUDA
    tensors (FSDP2 calls it with its own buffers)."""

    def allocate(self, size, *, dtype, device):
        return torch.empty(size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, async_op=False):
        all_gather_into(output_tensor, input_tensor, group)
        return None


class HostReduceScatter:
    """FSDP2's reduce-scatter through host memory (see
    :class:`HostAllGather`)."""

    def allocate(self, size, *, dtype, device):
        return torch.empty(size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, op,
                 async_op=False):
        reduce_scatter(output_tensor, input_tensor, group, op)
        return None


def place_zero3(module: nn.Module, mesh, rules: Optional[Callable] = None,
                blocks: Iterable[nn.Module] = (),
                divide_factor: Optional[float] = None,
                axis: str = "fsdp") -> nn.Module:
    """The ZeRO-3 placement shared by every model family: each parameter's
    spec from ``rules`` (default :func:`fsdp_rules`); its tensor and
    expert axes become DTensor placements (:func:`~ddstore_tpu_torch.
    parallel.tp.shard_pytree`), and its ``axis`` dim the dim FSDP2 shards
    it on. ``blocks`` (the transformer's blocks) are wrapped each on its
    own, so one block's parameters are gathered at a time, then
    ``module``. Parameters that ``axis`` does not shard are left out of
    FSDP. ``divide_factor`` replaces FSDP2's division of the reduced
    gradients by the data ranks (1.0: a sum). The optimizer is made after,
    on the placed parameters. In place; returns ``module``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    rules = rules or fsdp_rules(mesh, axis)
    specs = {n: torch_spec(rules, n, p) for n, p in module.named_parameters()}
    shard_pytree(module, mesh, lambda path, leaf: tuple(
        None if e == axis else e for e in rules(path, leaf)))
    dims, ignored = {}, set()
    for n, p in module.named_parameters():
        if axis in specs[n]:
            dims[p] = specs[n].index(axis)
        else:
            ignored.add(p)
    fmesh = fsdp_mesh(mesh, axis)

    def placement(p):
        return Shard(dims[p])

    wrapped = []
    for blk in list(blocks) + [module]:
        fully_shard(blk, mesh=fmesh, shard_placement_fn=placement,
                    ignored_params=ignored)
        wrapped.append(blk)
    for m in wrapped:
        if divide_factor is not None:
            # a plain SUM and a division after (gloo has no PREMUL_SUM)
            m.set_gradient_divide_factor(divide_factor)
            m.set_force_sum_reduction_for_comms(True)
        if _on_gloo_card(module, fmesh):
            m.set_custom_all_gather(HostAllGather())
            m.set_custom_reduce_scatter(HostReduceScatter())
    return module


def _on_gloo_card(module: nn.Module, fmesh) -> bool:
    p = next(module.parameters())
    probe = torch.empty(0, device=p.device)
    return any(staged(probe, fmesh.get_group(i), "all_gather_into_tensor")
               for i in range(fmesh.ndim))
