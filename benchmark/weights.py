"""The initial weights, made on the device from the seed.

One layout, by the names of the port's ``TransformerLM`` state dict, is
filled for both sides: the program loads it, and the reference computes
on it. Every matrix is drawn N(0, initializer_range^2) (the published
configs' ``initializer_range``) in one ``torch.randn`` call on a
generator seeded with the run's seed; biases are 0, LayerNorm scales 1.
The same seed on the same device gives the same weights, so the
reference makes them again after the window instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Layout = List[Tuple[str, Tuple[int, ...], str]]


def layout(model: Dict) -> Layout:
    """(name, shape, init) of every parameter, in the order of the port's
    ``named_parameters()``; init is ``"normal"``, ``"zeros"`` or
    ``"ones"``."""
    v, d = model["vocab"], model["dim"]
    f = model["mlp_ratio"] * d
    out: Layout = [("embed.tok.weight", (v, d), "normal")]
    for i in range(model["layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.weight", (d,), "ones"),
                (p + "ln1.bias", (d,), "zeros"),
                (p + "qkv.weight", (3 * d, d), "normal"),
                (p + "proj.weight", (d, d), "normal"),
                (p + "ln2.weight", (d,), "ones"),
                (p + "ln2.bias", (d,), "zeros"),
                (p + "up.weight", (f, d), "normal"),
                (p + "up.bias", (f,), "zeros"),
                (p + "down.weight", (d, f), "normal"),
                (p + "down.bias", (d,), "zeros")]
    out += [("lmhead.lnf.weight", (d,), "ones"),
            ("lmhead.lnf.bias", (d,), "zeros"),
            ("lmhead.head.weight", (v, d), "normal")]
    return out


def make(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The f32 parameters of ``seed``: name -> tensor on ``device``. The
    matrices are views of one buffer filled by one ``randn`` call."""
    lay = layout(model)
    sizes = [math.prod(s) for _, s, init in lay if init == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    flat.mul_(model["initializer_range"])
    out, off = {}, 0
    for name, shape, init in lay:
        if init == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
