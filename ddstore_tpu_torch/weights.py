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

Pipeline stages carry the reference's ``(outer, stages)`` state
(``ddstore_tpu/models/transformer.py:452-513``): ``outer = {"params":
{"embed", "lmhead"}}`` and ``stages = {"layer{j}": block tree stacked
along a leading chunk dim, "_valid": (chunks, g) f32}``, the chunks in
the device-major order of ``interleave_order``. :func:`from_flax_stages`
loads this rank's part of it into a ``PipelineStage``,
:func:`stage_tree` takes a stage's part back out, :func:`join_stage_trees`
stacks every stage's parts into the reference's state (``to_flax_stages``
of a list of stages), and :func:`tree_from_stages` is the reference's
``lm_from_stages`` on numpy trees.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

__all__ = ["from_flax", "to_flax", "flax_name", "full_tensor",
           "from_flax_stages", "to_flax_stages", "stage_tree",
           "join_stage_trees", "tree_from_stages"]


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


# ---------------------------------------------------------------------------
# Pipeline stages: the reference's (outer, stages) state.
# ---------------------------------------------------------------------------


def _interleave_order(n_stages: int, n_virtual: int):
    return [v * n_stages + d for d in range(n_stages)
            for v in range(n_virtual)]


def _group_size(layers: int, n_chunks: int) -> int:
    g = -(-layers // n_chunks)
    if layers <= (n_chunks - 1) * g:
        raise ValueError(
            f"{n_chunks} stages of {g} layers leave at least one stage "
            f"with zero real layers (layers={layers}); use fewer stages")
    return g


def _get(tree: Mapping[str, Any], path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _put(tree: Dict[str, Any], path: str, value) -> None:
    *parts, leaf = path.split("/")
    for part in parts:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _chunk_key(name: str):
    """``chunks.{v}.layers.{j}.rest`` -> (v, j, the block leaf's flax
    path); ``chunks.{v}._valid`` -> (v, None, "_valid"); None for the
    embedding and the head."""
    parts = name.split(".")
    if parts[0] != "chunks":
        return None
    v = int(parts[1])
    if parts[2] == "_valid":
        return v, None, "_valid"
    j = int(parts[3])
    block = flax_name("blocks.0." + ".".join(parts[4:]))
    return v, j, block.split("/", 1)[1]


@torch.no_grad()
def from_flax_stages(outer: Mapping[str, Any], stages: Mapping[str, Any],
                     stage: nn.Module) -> nn.Module:
    """Load this rank's part of the reference's ``(outer, stages)``
    state into ``stage`` (a ``PipelineStage`` before it is placed): its
    chunks from rows ``[d·V, (d + 1)·V)`` of the stacks, the ``_valid``
    mask from the float leaf (> 0.5), and the embedding or the head where
    the stage holds them. Every tensor of the stage must be present with
    the expected shape."""
    out = outer["params"] if "params" in outer else outer
    v = stage.n_virtual
    state = {}
    for name, p in stage.state_dict().items():
        if hasattr(p, "placements"):
            raise ValueError(f"{name} is sharded; load the weights before "
                             f"placing the stage")
        key = _chunk_key(name)
        if key is None:
            path = flax_name(name)
            arr = np.asarray(_get(out, path), np.float32)
        else:
            row = stage.stage * v + key[0]
            if key[2] == "_valid":
                arr = np.asarray(stages["_valid"])[row] > 0.5
                state[name] = torch.from_numpy(np.array(arr))
                continue
            path = key[2]
            arr = np.asarray(_get(stages[f"layer{key[1]}"], path),
                             np.float32)[row]
        if path.endswith("/kernel"):
            arr = arr.T
        arr = np.array(arr, order="C")
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit "
                             f"{name} {tuple(p.shape)}")
        state[name] = torch.from_numpy(arr)
    stage.load_state_dict(state)
    for chunk in stage.chunks:
        chunk.valid = [bool(b) for b in chunk._valid.tolist()]
    return stage


def stage_tree(stage: nn.Module,
               tensors: Mapping[str, torch.Tensor] = None) -> Dict[str, Any]:
    """A stage's part of the ``(outer, stages)`` state as numpy f32
    leaves: ``{"outer": {"embed"?, "lmhead"?}, "rows": {row: {"layer{j}":
    block tree, "_valid": (g,)}}}``, kernels ``(in, out)``, sharded
    tensors gathered whole (a collective of their meshes). ``tensors``
    maps parameter names to tensors of their shapes to take in their
    place (``{n: p.grad ...}``; None counts as zeros)."""
    v = stage.n_virtual
    piece: Dict[str, Any] = {"outer": {}, "rows": {}}
    items = dict(stage.state_dict())
    if tensors is not None:
        items.update({n: torch.zeros_like(items[n]) if t is None else t
                      for n, t in tensors.items()})
    for name, t in items.items():
        key = _chunk_key(name)
        arr = full_tensor(t.detach()).to("cpu", torch.float32).numpy()
        if key is None:
            path = flax_name(name)
            node = piece["outer"]
        else:
            row = piece["rows"].setdefault(stage.stage * v + key[0], {})
            if key[2] == "_valid":
                row["_valid"] = np.array(arr)
                continue
            path = f"layer{key[1]}/{key[2]}"
            node = row
        if path.endswith("/kernel"):
            arr = arr.T
        _put(node, path, np.array(arr, order="C"))
    return piece


def join_stage_trees(pieces, layers: int, n_stages: int,
                     n_virtual: int = 1):
    """The reference's ``(outer, stages)`` from every stage's
    :func:`stage_tree`: the block leaves stacked over the ``V·S`` rows,
    ``_valid`` as f32."""
    outer: Dict[str, Any] = {}
    rows: Dict[int, Any] = {}
    for piece in pieces:
        for k, sub in piece["outer"].items():
            outer[k] = sub
        rows.update(piece["rows"])
    n = n_stages * n_virtual
    if sorted(rows) != list(range(n)):
        raise ValueError(f"stage rows {sorted(rows)} are not the {n} of "
                         f"{n_stages} stages x {n_virtual} chunks")
    g = _group_size(layers, n)
    stages: Dict[str, Any] = {}
    for j in range(g):
        flat = [_leaves(rows[r][f"layer{j}"]) for r in range(n)]
        tree: Dict[str, Any] = {}
        for path in flat[0]:
            _put(tree, path, np.stack([f[path] for f in flat]))
        stages[f"layer{j}"] = tree
    stages["_valid"] = np.stack([rows[r]["_valid"] for r in range(n)]
                                ).astype(np.float32)
    return {"params": outer}, stages


def to_flax_stages(stages_of_every_rank):
    """``join_stage_trees`` of ``PipelineStage`` modules, one per stage
    (in one process)."""
    first = stages_of_every_rank[0]
    return join_stage_trees([stage_tree(s) for s in stages_of_every_rank],
                            first.layers, first.n_stages, first.n_virtual)


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    return {k: np.asarray(v) for k, v in _flatten(tree, prefix).items()}


def tree_from_stages(outer: Mapping[str, Any], stages: Mapping[str, Any],
                     layers: int, n_stages: int, n_virtual: int = 1
                     ) -> Dict[str, Any]:
    """The reference's ``lm_from_stages`` on a numpy tree: the flat
    ``{"params": ...}`` tree, pads dropped."""
    n = n_stages * n_virtual
    g = _group_size(layers, n)
    order = _interleave_order(n_stages, n_virtual)
    p = dict(outer["params"] if "params" in outer else outer)
    for pos, c in enumerate(order):
        for j in range(g):
            li = c * g + j
            if li < layers:
                tree: Dict[str, Any] = {}
                for path, leaf in _flatten(stages[f"layer{j}"]).items():
                    _put(tree, path, np.asarray(leaf)[pos])
                p[f"block{li}"] = tree
    return {"params": p}
