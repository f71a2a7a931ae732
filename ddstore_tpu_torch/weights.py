"""Carry a flax ``TransformerLM`` parameter tree into the port's model.

The tree is the reference's (``ddstore_tpu/models/transformer.py``), as
numpy arrays: ``embed/tok/embedding``, ``block{i}/{ln1,ln2}/{scale,bias}``,
``block{i}/{qkv,proj}/kernel``, ``block{i}/{up,down}/{kernel,bias}`` and
``lmhead/{lnf/{scale,bias},head/kernel}``. Dense kernels are ``(in, out)``
and torch ``Linear`` weights ``(out, in)``, so kernels are transposed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.transformer import TransformerLM

__all__ = ["from_flax"]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _flax_name(torch_name: str) -> str:
    """``blocks.0.qkv.weight`` -> ``block0/qkv/kernel`` and so on."""
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
def from_flax(params: Mapping[str, Any], model: TransformerLM
              ) -> TransformerLM:
    """Load ``params`` (the flax tree, with or without its top-level
    ``"params"`` key) into ``model`` in place and return it. Every
    parameter must be present with the expected shape, and nothing
    else."""
    if "params" in params:
        params = params["params"]
    flat = _flatten(params)
    state = {}
    for name, p in model.state_dict().items():
        key = _flax_name(name)
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
