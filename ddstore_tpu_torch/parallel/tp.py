"""Tensor and expert parallelism as DTensor placements (the port of
``ddstore_tpu/parallel/tp.py:25-143``).

The reference places parameters by rules and lets GSPMD insert the
collectives. Here the rules are the same functions of a leaf's flax path
and shape (:func:`megatron_rules`, :func:`expert_rules`), returning a spec
like a ``PartitionSpec``: one entry a dim, ``None`` or a mesh axis.
:func:`torch_spec` reads one for a torch parameter through the flax name
and the transpose of Dense kernels (flax ``(in, out)``, torch ``(out,
in)``: ``P(None, "tp")`` becomes ``("tp", None)``, ``Shard(0)``), and
:func:`shard_pytree` makes every sharded parameter a DTensor over the mesh
axes its spec names, holding this rank's shard.

The layers then compute on their local shards, and take their collectives
from their parameters' placements (Megatron's pair of
:mod:`~ddstore_tpu_torch.parallel.collectives`): a column-parallel
product sums its input's gradient over ``tp``, a row-parallel one sums
its output over ``tp``, and the experts sum over ``ep``
(:mod:`~ddstore_tpu_torch.models.moe`).

**One departure.** ``megatron_rules`` column-shards the fused ``qkv``
kernel ``(dim, 3 * dim)`` as one block, so with 4 heads over tp 4 rank 0
would hold 24 columns, all of them q; GSPMD reshards that silently, a
hand-written TP cannot. Here ``qkv`` shards q, k and v each by heads
(:class:`Strided`, a ``_StridedShard`` placement of the fused weight), so
a rank's attention runs the flash kernel on its own ``H / tp`` heads.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .mesh import Placement, axis_index, axis_size

__all__ = ["Strided", "megatron_rules", "expert_rules", "pp_stage_rules",
           "stage_local_rules", "torch_spec",
           "shard_pytree", "shardings_of", "local_shard", "to_placements"]


class Strided(NamedTuple):
    """A dim split into ``split`` equal blocks, each sharded over
    ``axis`` (rank ``i`` holds the ``i``-th piece of every block)."""

    axis: str
    split: int


def megatron_rules(axis: str = "tp") -> Callable:
    """Rules for the transformer family's parameter names, in flax terms:

    ==================  ========================================
    qkv kernel           P(None, Strided(tp, 3))  (column, by heads)
    up kernel            P(None, tp)   (column)
    proj/down kernel     P(tp, None)   (row)
    head kernel          P(None, tp)   (vocab)
    up bias              P(tp)
    everything else      replicated
    ==================  ========================================
    """

    def rules(path, leaf):
        names = set(path)
        if leaf.ndim >= 2:
            if "qkv" in names and path[-1] == "kernel":
                return (None,) * (leaf.ndim - 1) + (Strided(axis, 3),)
            if "up" in names and path[-1] == "kernel":
                return (None,) * (leaf.ndim - 1) + (axis,)
            if {"proj", "down"} & names and path[-1] == "kernel":
                return (axis,) + (None,) * (leaf.ndim - 1)
            if "head" in names and path[-1] == "kernel":
                return (None, axis)
        if leaf.ndim == 1 and "up" in names and path[-1] == "bias":
            return (axis,)
        return ()

    return rules


def expert_rules(ep_axis: str = "ep",
                 tp_axis: Optional[str] = None) -> Callable:
    """Expert parallelism: the leading (expert) dim of the MoE weights
    over ``ep_axis``, the experts' hidden dim over ``tp_axis`` when given,
    and :func:`megatron_rules` over ``tp_axis`` for everything else."""
    base = megatron_rules(tp_axis) if tp_axis else None

    def rules(path, leaf):
        if "moe" in set(path):
            if path[-1] == "w1":
                return (ep_axis, None, tp_axis)
            if path[-1] == "w2":
                return (ep_axis, tp_axis, None)
            if path[-1] == "b1":
                return (ep_axis, tp_axis)
            if path[-1] == "b2":
                return (ep_axis, None)
            return ()  # router replicated
        return base(path, leaf) if base else ()

    return rules


def pp_stage_rules(pp_axis: str = "pp", tp_axis: Optional[str] = None,
                   ep_axis: Optional[str] = None) -> Callable:
    """Rules for a STAGE-STACKED parameter tree (leading dim the stage,
    over ``pp_axis``), with Megatron's tensor parallelism and, for MoE
    stacks, expert parallelism on the other dims (pp x tp, pp x ep):

    ==================  =========================================
    every leaf           dim 0 = pp
    qkv kernel           (pp, None, Strided(tp, 3))  (by heads)
    up kernel            (pp, None, tp)   (column)
    proj/down kernel     (pp, tp, None)   (row)
    up bias              (pp, tp)
    moe w1 / w2          (pp, ep, None, tp) / (pp, ep, tp, None)
    moe b1 / b2          (pp, ep, tp) / (pp, ep, None)
    everything else      (pp, None, ...)
    ==================  =========================================

    The reference's (``tp.py:72-118``) with ``qkv`` by heads, as
    :func:`megatron_rules`. A rank holds its own stage's layers, not the
    stack: :func:`stage_local_rules` reads these for them."""

    def rules(path, leaf):
        nd = leaf.ndim
        spec = [pp_axis] + [None] * (nd - 1)
        names = set(path)
        if "moe" in names:
            if path[-1] in ("w1", "w2", "b1", "b2") and nd >= 3:
                spec[1] = ep_axis  # expert dim (None when ep unset)
            if tp_axis:
                if path[-1] == "w1" and nd == 4:
                    spec[3] = tp_axis
                elif path[-1] == "w2" and nd == 4:
                    spec[2] = tp_axis
                elif path[-1] == "b1" and nd == 3:
                    spec[2] = tp_axis
        elif tp_axis:
            if path[-1] == "kernel" and nd >= 3:
                if "qkv" in names:
                    spec[-1] = Strided(tp_axis, 3)
                elif "up" in names:
                    spec[-1] = tp_axis
                elif {"proj", "down"} & names:
                    spec[1] = tp_axis
            elif path[-1] == "bias" and nd == 2 and "up" in names:
                spec[1] = tp_axis
        return tuple(spec)

    return rules


def stage_local_rules(stacked: Callable) -> Callable:
    """Rules for one stage's own layers from rules of the stage-stacked
    tree (:func:`pp_stage_rules`): a layer's leaf read as a row of the
    stack, its stage entry dropped."""

    def rules(path, leaf):
        row = torch.empty((1,) + tuple(leaf.shape), device="meta")
        return tuple(stacked(path, row))[1:]

    return rules


def torch_spec(rules: Callable, name: str, param: torch.Tensor
               ) -> Tuple:
    """``rules``' spec for the torch parameter ``name`` (as
    ``named_parameters`` gives it), one entry a torch dim."""
    from ..weights import flax_name

    key = flax_name(name)
    transposed = key.endswith("/kernel")
    shape = tuple(param.shape)[::-1] if transposed else tuple(param.shape)
    spec = tuple(rules(tuple(key.split("/")), torch.empty(shape,
                                                          device="meta")))
    spec = spec + (None,) * (len(shape) - len(spec))
    return spec[::-1] if transposed else spec


def _axis(entry) -> Optional[str]:
    return entry.axis if isinstance(entry, Strided) else entry


def to_placements(spec: Tuple, mesh) -> Optional[Placement]:
    """The DTensor placement of ``spec``: the sub-mesh of the axes it
    names (in the mesh's order) and a ``Shard`` (``_StridedShard`` for
    :class:`Strided`) for each; None when it names none of size > 1."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    dims = {_axis(e): d for d, e in enumerate(spec)
            if e is not None and axis_size(mesh, _axis(e)) > 1}
    if not dims:
        return None
    axes = tuple(a for a in mesh.mesh_dim_names if a in dims)
    pls = []
    for a in axes:
        e, d = spec[dims[a]], dims[a]
        pls.append(_StridedShard(d, split_factor=e.split)
                   if isinstance(e, Strided) else Shard(d))
    sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]
    return Placement(sub, tuple(pls))


def local_shard(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under ``spec``."""
    for d, e in enumerate(spec):
        a = _axis(e)
        n = axis_size(mesh, a) if a is not None else 1
        if n == 1:
            continue
        i = axis_index(mesh, a)
        split = e.split if isinstance(e, Strided) else 1
        if t.shape[d] % (split * n):
            raise ValueError(f"dim {d} of size {t.shape[d]} does not split "
                             f"into {split} x {n} equal shards over {a!r}")
        t = torch.cat([blk.chunk(n, d)[i] for blk in t.chunk(split, d)], d)
    return t.contiguous()


def _set_param(module: nn.Module, name: str, value: nn.Parameter) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, leaf, value)


@torch.no_grad()
def shard_pytree(module: nn.Module, mesh, rules: Callable) -> nn.Module:
    """Place every parameter of ``module`` by ``rules(path, leaf) ->
    spec`` (flax terms, read through :func:`torch_spec`): a parameter
    whose spec shards it becomes a DTensor holding this rank's shard of
    the full tensor every rank holds; the others stay as they are
    (replicated). In place; returns ``module``."""
    from torch.distributed.tensor import DTensor

    for name, p in list(module.named_parameters()):
        spec = torch_spec(rules, name, p)
        pl = to_placements(spec, mesh)
        if pl is None:
            continue
        local = local_shard(p.detach(), spec, mesh)
        dt = DTensor.from_local(local, pl.mesh, pl.placements,
                                run_check=False, shape=p.shape,
                                stride=p.stride())
        _set_param(module, name, nn.Parameter(dt, requires_grad=
                                              p.requires_grad))
    return module


def shardings_of(module: nn.Module) -> Dict[str, Optional[Placement]]:
    """Each parameter's placement by name (None: a plain, replicated
    tensor)."""
    return {n: Placement(p.device_mesh, tuple(p.placements))
            if hasattr(p, "placements") else None
            for n, p in module.named_parameters()}
