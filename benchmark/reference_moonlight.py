"""The plain reference of ``moonlight-16b-a3b``: DeepSeek-V3's block as the
configuration runs it (``configs/moonlight-16b-a3b.json``), its loss, its
gradients, Adam and the selection bias's update, in plain PyTorch.

Each layer: RMSNorm; multi-head latent attention (q = W_q h as heads x
(nope + rope); [c, k_r] = W_kva h, c RMSNormed; [k_nope, v] = W_kvb c;
the pairs (2i, 2i+1) of q's and k_r's rotary features turned by pos *
theta^(-2i/rope); k_r shared by the heads; causal softmax at 1/sqrt(nope +
rope)); RMSNorm; the MLP: a SwiGLU in the leading dense layers, else the
shared experts' SwiGLU plus, for each chosen expert this chip holds, its
gate times its SwiGLU. Scores are the sigmoid of the f32 router logits;
the top k of score plus bias are chosen; a gate is ``scale * s_i / sum of
the chosen s``. The loss adds alpha times DeepSeek-V3's sequence-wise
balance loss of every expert layer, averaged over the rows. After each
step every layer's bias moves by ``gamma * sign(mean load - load)``.

It computes in float32 with TF32 off, each layer under
``torch.utils.checkpoint`` and attention by blocks of queries over the
keys they can see (exact), so that 27 layers of 8,192 tokens fit. It
imports torch and ``reference.py``'s precision helpers alone: nothing of
the program it judges. ``prec="fp8"`` is the control, as in
``reference.py``; ``faults`` plants the faults the limits are checked
against (``softmax``: softmax scores in place of sigmoid; ``gate_bias``:
gates from the biased scores; ``half``: half of each row's tokens left out
of the loss).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .reference import (ADAM_B1, ADAM_B2, ADAM_EPS, _matmul, exact_matmuls,
                        leaf_norms)

QUERY_BLOCK = 1024


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, ..., D) with each pair (2i, 2i+1) turned by pos *
    theta^(-2i/D), pos the index along S."""
    b, s, d = x.shape[0], x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    ang = ang.view(1, s, *([1] * (x.dim() - 3)), d // 2)
    x0, x1 = x[..., 0::2], x[..., 1::2]
    c, si = torch.cos(ang), torch.sin(ang)
    return torch.stack([x0 * c - x1 * si, x0 * si + x1 * c],
                       dim=-1).flatten(-2)


def _swiglu(x, w_gate_up, w_down, prec):
    g, u = _matmul(x, w_gate_up, prec).chunk(2, dim=-1)
    return _matmul(F.silu(g) * u, w_down, prec)


def _attention(x, P, p, m, prec):
    b, s, d = x.shape
    nh, nope, rope, vd = m["heads"], m["qk_nope"], m["qk_rope"], m["v_dim"]
    eps = m["norm_eps"]
    h = _rms(x, P[p + "ln1.weight"], eps)
    q = _matmul(h, P[p + "q.weight"].t(), prec).view(b, s, nh, nope + rope)
    c, k_r = _matmul(h, P[p + "kv_a.weight"].t(), prec).split(
        [m["kv_rank"], rope], -1)
    c = _rms(c, P[p + "kv_norm.weight"], eps)
    kv = _matmul(c, P[p + "kv_b.weight"].t(), prec).view(b, s, nh,
                                                          nope + vd)
    k_nope, v = kv.split([nope, vd], -1)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], m["rope_theta"])],
                  -1).transpose(1, 2)
    k_r = _rope(k_r[:, :, None, :], m["rope_theta"]).expand(b, s, nh, rope)
    k = torch.cat([k_nope, k_r], -1).transpose(1, 2)
    v = v.transpose(1, 2)
    scale = 1.0 / math.sqrt(nope + rope)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        sc = _matmul(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2),
                     prec) * scale
        mask = torch.ones(hi - lo, hi, dtype=torch.bool,
                          device=x.device).triu(lo + 1)
        pr = torch.softmax(sc.masked_fill(mask, float("-inf")), dim=-1)
        outs.append(_matmul(pr, v[:, :, :hi], prec))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, nh * vd)
    return x + _matmul(o, P[p + "proj.weight"].t(), prec)


def _experts(h, P, p, m, bias, prec, faults):
    """(the expert layer's output, its balance loss, its counts a
    expert) of the normed input ``h`` (B, S, d)."""
    b, s, d = h.shape
    e, k = m["experts"], m["top_k"]
    first, count = m["held"]
    x = h.reshape(b * s, d)
    logits = _matmul(x, P[p + "moe.router.weight"].t(), prec)
    sc = torch.softmax(logits, -1) if "softmax" in faults \
        else torch.sigmoid(logits)
    idx = torch.topk(sc.detach() + bias, k, dim=-1).indices
    chosen = (sc + bias if "gate_bias" in faults else sc).gather(1, idx)
    gates = m["scale"] * chosen / chosen.sum(-1, keepdim=True)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    y = _swiglu(x, P[p + "moe.shared_gate_up.weight"].t(),
                P[p + "moe.shared_down.weight"].t(), prec)
    for j in range(count):
        tok, slot = (idx == first + j).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        out = _swiglu(x[tok], P[p + "moe.w_in"][j], P[p + "moe.w_out"][j],
                      prec)
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    hits = F.one_hot(idx, e).sum(1).view(b, s, e).sum(1).float()
    f = hits * (e / (k * s))
    pr = (sc / sc.sum(-1, keepdim=True)).view(b, s, e).mean(1)
    balance = m["balance"] * (f * pr).sum(-1).mean()
    return y.view(b, s, d), balance, counts


def _layer(i, x, P, m, biases, prec, faults, side):
    p = f"blocks.{i}."
    x = _attention(x, P, p, m, prec)
    h = _rms(x, P[p + "ln2.weight"], m["norm_eps"])
    if i < m["dense_layers"]:
        return x + _swiglu(h, P[p + "gate_up.weight"].t(),
                           P[p + "down.weight"].t(), prec), \
            x.new_zeros(())
    y, balance, counts = _experts(h, P, p, m, biases[i], prec, faults)
    side[i] = counts
    return x + y, balance


def nll(P: Dict[str, torch.Tensor], m: Dict, biases: Dict[int, torch.Tensor],
        tokens: torch.Tensor, targets: torch.Tensor, prec: str = "f32",
        faults: Sequence[str] = ()) -> Tuple[torch.Tensor, torch.Tensor,
                                             Dict[int, torch.Tensor]]:
    """(each token's negative log-likelihood (rows, seq) f32, the summed
    balance losses, each expert layer's assignment counts (experts,))."""
    x = P["embed.tok.weight"][tokens.long()]
    total = x.new_zeros(())
    counts: Dict[int, torch.Tensor] = {}
    for i in range(m["layers"]):
        side: Dict[int, torch.Tensor] = {}
        x, bal = checkpoint(_layer, i, x, P, m, biases, prec, tuple(faults),
                            side, use_reentrant=False)
        counts.update(side)
        total = total + bal
    y = _rms(x, P["lmhead.lnf.weight"], m["norm_eps"])
    out = []
    for lo in range(0, y.shape[1], QUERY_BLOCK):
        lg = _matmul(y[:, lo:lo + QUERY_BLOCK], P["lmhead.head.weight"].t(),
                     prec)
        tg = targets[:, lo:lo + QUERY_BLOCK].long()
        out.append(torch.logsumexp(lg, -1)
                   - lg.gather(-1, tg[..., None])[..., 0])
    return torch.cat(out, dim=1), total, counts


def train(m: Dict, make_params, batches: Sequence[Tuple], lr: float,
          prec: str = "f32", faults: Sequence[str] = ()
          ) -> Tuple[List[float], Dict[str, float], Dict[str, float],
                     List[List[int]]]:
    """Adam from the weights ``make_params()`` over ``batches`` ((tokens,
    targets) of each step), the biases starting at 0: (each step's loss,
    each leaf's first-gradient norm, each leaf's change norm after the
    last step, step 1's assignment counts of each expert layer)."""
    P = {k: v.detach().requires_grad_() for k, v in make_params().items()}
    mo = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    dev = next(iter(P.values())).device
    biases = {i: torch.zeros(m["experts"], device=dev)
              for i in range(m["dense_layers"], m["layers"])}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    counts1: List[List[int]] = []
    with exact_matmuls():
        for t, (tok, tgt) in enumerate(batches, start=1):
            per_tok, balance, counts = nll(P, m, biases, tok, tgt, prec,
                                           faults)
            if "half" in faults:
                per_tok = per_tok[:, :per_tok.shape[1] // 2]
            loss = per_tok.mean() + balance
            loss.backward()
            losses.append(float(loss.detach()))
            if t == 1:
                grad1 = leaf_norms({k: p.grad for k, p in P.items()})
                counts1 = [counts[i].tolist() for i in sorted(counts)]
            with torch.no_grad():
                c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
                for k, p in P.items():
                    g = p.grad
                    mo[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v2[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    denom = (v2[k].sqrt() / math.sqrt(c2)).add_(ADAM_EPS)
                    p.addcdiv_(mo[k], denom, value=-lr / c1)
                    p.grad = None
                for i, c in counts.items():
                    load = c.float()
                    biases[i].add_(torch.sign(load.mean() - load),
                                   alpha=m["bias_rate"])
    del mo, v2
    p0 = make_params()
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            P[k].detach() - p0[k], dtype=torch.float64)) for k in P}
    return losses, grad1, change, counts1


def routing_gap(prog: List[List[int]], ref: List[List[int]]) -> float:
    """The L1 gap of two runs' assignment counts, over every expert of
    every expert layer, over the reference's assignments."""
    num = sum(abs(a - b) for pl, rl in zip(prog, ref)
              for a, b in zip(pl, rl))
    return num / max(1, sum(sum(r) for r in ref))
