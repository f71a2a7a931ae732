"""Carry a flax ``TransformerLM``, ``VAE`` or ``MPNN`` parameter tree
into the port's model, and back.

The trees are the reference's, as numpy arrays. ``TransformerLM``
(``ddstore_tpu/models/transformer.py``): ``embed/tok/embedding``,
``block{i}/{ln1,ln2}/{scale,bias}``, ``block{i}/{qkv,proj}/kernel``,
``block{i}/{up,down}/{kernel,bias}`` and
``lmhead/{lnf/{scale,bias},head/kernel}``; an MoE block has
``block{i}/moe/router/kernel`` and the raw expert parameters
``block{i}/moe/{w1,b1,w2,b2}`` in place of ``up``/``down``. ``VAE``
(``ddstore_tpu/models/vae.py``): ``encoder/Dense_{0,1,2}`` (hidden, mu,
logvar) and ``decoder/Dense_{0,1}`` (hidden, logits), each with
``kernel`` and ``bias``. ``MPNN`` (``ddstore_tpu/models/gnn.py``):
``embed``, ``msg{l}_{0,1}``, ``upd{l}_{0,1}`` and ``readout_{0,1}``,
each with ``kernel`` and ``bias``, and ``ln{l}/{scale,bias}``; the
port's submodules carry the same names. Dense kernels are ``(in, out)``
and torch ``Linear`` weights ``(out, in)``, so kernels are transposed;
a LayerNorm's ``scale`` is its ``weight``. The expert parameters are not
Dense kernels and keep their layout. :func:`to_flax` is the inverse of
:func:`from_flax`; the tests use it to compare gradients and optimizer
updates leaf by leaf, by flax path. A sharded model (DTensor parameters:
tensor, expert or fully-sharded parallelism) is carried through its full
tensors: :func:`to_flax` gathers them (a collective of the model's
ranks), and :func:`from_flax` loads a model before it is placed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax", "to_flax", "flax_name", "full_tensor"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


# the VAE's Linear layers and the flax Dense modules they stand for
_VAE_DENSE = {"encoder.fc": "encoder/Dense_0",
              "encoder.fc_mu": "encoder/Dense_1",
              "encoder.fc_logvar": "encoder/Dense_2",
              "decoder.fc": "decoder/Dense_0",
              "decoder.fc_out": "decoder/Dense_1"}


def flax_name(torch_name: str) -> str:
    """``blocks.0.qkv.weight`` -> ``block0/qkv/kernel``,
    ``encoder.fc_mu.bias`` -> ``encoder/Dense_1/bias`` and so on."""
    layer, _, leaf = torch_name.rpartition(".")
    if layer in _VAE_DENSE:
        return f"{_VAE_DENSE[layer]}/{'kernel' if leaf == 'weight' else leaf}"
    parts = torch_name.split(".")
    if parts[0] == "blocks":
        parts = [f"block{parts[1]}"] + parts[2:]
    leaf = parts[-1]
    if leaf == "weight":
        if parts[-2] == "tok":
            leaf = "embedding"
        elif parts[-2].startswith("ln"):
            leaf = "scale"
        else:
            leaf = "kernel"
    return "/".join(parts[:-1] + [leaf])


@torch.no_grad()
def from_flax(params: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load ``params`` (the flax tree, with or without its top-level
    ``"params"`` key) into ``model`` in place and return it. Every
    parameter must be present with the expected shape, and nothing
    else."""
    if "params" in params:
        params = params["params"]
    flat = _flatten(params)
    state = {}
    for name, p in model.state_dict().items():
        if hasattr(p, "placements"):
            raise ValueError(f"{name} is sharded; load the weights before "
                             f"placing the model")
        key = flax_name(name)
        if key not in flat:
            raise KeyError(f"flax tree has no {key} (for {name})")
        arr = np.asarray(flat.pop(key), dtype=np.float32)
        if key.endswith("/kernel"):
            arr = arr.T
        arr = np.array(arr, order="C")  # a writable copy
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key}: shape {arr.shape} does not fit "
                             f"{name} {tuple(p.shape)}")
        state[name] = torch.from_numpy(arr)
    if flat:
        raise KeyError(f"flax tree has parameters the model lacks: "
                       f"{sorted(flat)}")
    model.load_state_dict(state)
    return model


def to_flax(src: Union[nn.Module, Mapping[str, torch.Tensor]]
            ) -> Dict[str, Any]:
    """The flax tree ``{"params": {...}}`` of numpy f32 leaves, kernels
    transposed back to ``(in, out)``. ``src`` is the model (its
    parameters) or a mapping of the model's parameter names to tensors of
    the same shapes, such as ``{n: p.grad for n, p in
    model.named_parameters()}``. ``to_flax(from_flax(p, m))`` gives ``p``
    back exactly."""
    items = src.state_dict().items() if isinstance(src, nn.Module) \
        else src.items()
    tree: Dict[str, Any] = {}
    for name, t in items:
        key = flax_name(name)
        arr = full_tensor(t.detach()).to("cpu", torch.float32).numpy()
        if key.endswith("/kernel"):
            arr = arr.T
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.array(arr, order="C")
    return {"params": tree}


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor, a plain tensor as it is. A
    collective of the DTensor's mesh: its shards are gathered through host
    memory with ``all_gather`` over each sharded mesh dim, the innermost
    first (gloo, two ranks on one card, takes no CUDA tensor in DTensor's
    own all-gather), and put back in place: a ``Shard(d)`` concatenates
    the ranks' shards along ``d``; a ``_StridedShard(d, split_factor=k)``
    (the per-head ``qkv``) interleaves them, rank ``r`` holding the
    ``r``-th piece of each of the ``k`` blocks."""
    if not hasattr(t, "full_tensor"):
        return t
    import torch.distributed as dist

    mesh = t.device_mesh
    local = t.to_local().detach().cpu()
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if pl.is_replicate():
            continue
        d = pl.dim  # a parameter is never a partial sum
        n = mesh.size(i)
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local.contiguous(), group=mesh.get_group(i))
        split = getattr(pl, "split_factor", 1)
        blocks = [p.chunk(split, d) for p in parts]
        local = torch.cat([blocks[r][j] for j in range(split)
                           for r in range(n)], d)
    return local.to(t.device)
