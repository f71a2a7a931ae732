"""The initial weights of ``moonlight-16b-a3b``, made on the device from
the seed, by the names of the port's ``TransformerLM`` state dict built
with latent attention and held experts; the program loads them and
``reference_moonlight.py`` computes on them.

As ``weights.py``: every matrix N(0, initializer_range^2) from one
``torch.randn`` call on a generator seeded with the run's seed, the
RMSNorm scales 1. The selection biases are buffers, not weights: both
sides start them at 0.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .weights import Layout


def layout(m: Dict) -> Layout:
    """(name, shape, init) of every parameter of the configuration's
    ``model``, in the order of the port's ``named_parameters()``."""
    v, d, nh = m["vocab"], m["dim"], m["heads"]
    qk = m["qk_nope"] + m["qk_rope"]
    h, count = m["expert_hidden"], m["held"][1]
    out: Layout = [("embed.tok.weight", (v, d), "normal")]
    for i in range(m["layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.weight", (d,), "ones"),
                (p + "q.weight", (nh * qk, d), "normal"),
                (p + "kv_a.weight", (m["kv_rank"] + m["qk_rope"], d),
                 "normal"),
                (p + "kv_norm.weight", (m["kv_rank"],), "ones"),
                (p + "kv_b.weight", (nh * (m["qk_nope"] + m["v_dim"]),
                                     m["kv_rank"]), "normal"),
                (p + "proj.weight", (d, nh * m["v_dim"]), "normal"),
                (p + "ln2.weight", (d,), "ones")]
        if i < m["dense_layers"]:
            f = m["dense_hidden"]
            out += [(p + "gate_up.weight", (2 * f, d), "normal"),
                    (p + "down.weight", (d, f), "normal")]
        else:
            f = m["shared"] * h
            out += [(p + "moe.w_in", (count, d, 2 * h), "normal"),
                    (p + "moe.w_out", (count, h, d), "normal"),
                    (p + "moe.router.weight", (m["experts"], d), "normal"),
                    (p + "moe.shared_gate_up.weight", (2 * f, d), "normal"),
                    (p + "moe.shared_down.weight", (d, f), "normal")]
    out += [("lmhead.lnf.weight", (d,), "ones"),
            ("lmhead.head.weight", (v, d), "normal")]
    return out


def make(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The f32 parameters of ``seed``: name -> tensor on ``device``, the
    matrices views of one buffer filled by one ``randn`` call."""
    lay = layout(m)
    sizes = [math.prod(s) for _, s, init in lay if init == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    flat.mul_(m["initializer_range"])
    out, off = {}, 0
    for name, shape, init in lay:
        if init == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
        else:
            out[name] = torch.ones(shape, device=device)
    return out
