"""The plain reference: the GPT block LM of the configurations, its loss,
its gradients and Adam, in plain PyTorch.

It follows the configuration as it is run (``configs/*.json``, including
the listed departures from the published models): pre-LayerNorm blocks
(eps from the file), multi-head causal attention with no qkv or proj
bias, a 4x MLP with bias and GELU in its tanh form, sinusoidal positions,
an untied vocab head. It computes in float32 with TF32 off (turned off
only inside :func:`exact_matmuls`, and torch's flags restored after), on
whole scores, in blocks of rows so that it fits. ``prec="fp8"`` is the
control: every product's operands rounded to fp8 with a per-tensor scale
(e4m3 forward, e5m2 gradients), as an fp8 training recipe computes them.

It imports torch alone: nothing of the program it judges. The positions'
formula is a frozen copy of the port's ``EmbedPE``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def exact_matmuls() -> Iterator[None]:
    """float32 products in float32: TF32 off for matmuls and cuDNN;
    torch's flags restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, returned in float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _FP8[dtype] / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on fp8 operands: e4m3 in the forward, the incoming
    gradient e5m2 in the backward, products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, torch.float8_e4m3fn), _fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        while db.dim() > qb.dim():  # a batched a against a shared b
            db = db.sum(0)
        return da, db


def _matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return torch.matmul(a, b)
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {prec!r}")


def positions(seq: int, dim: int, device) -> torch.Tensor:
    """(seq, dim) sinusoidal positions: sin then cos of pos * 10000^(-i /
    (dim/2))."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=device)
    freqs = torch.exp(-math.log(10000.0) * ar / half)
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] \
        * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def nll(P: Dict[str, torch.Tensor], model: Dict, tokens: torch.Tensor,
        targets: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Each token's negative log-likelihood, (rows, seq) float32."""
    d, h = model["dim"], model["heads"]
    hd, eps = d // h, model["ln_eps"]
    b, s = tokens.shape
    x = P["embed.tok.weight"][tokens.long()] + positions(s, d, tokens.device)
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=tokens.device).triu(1)
    for i in range(model["layers"]):
        p = f"blocks.{i}."
        y = F.layer_norm(x, (d,), P[p + "ln1.weight"], P[p + "ln1.bias"], eps)
        qkv = _matmul(y, P[p + "qkv.weight"].t(), prec)
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        sc = _matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
        pr = torch.softmax(sc.masked_fill(causal, float("-inf")), dim=-1)
        att = _matmul(pr, v, prec).transpose(1, 2).reshape(b, s, d)
        x = x + _matmul(att, P[p + "proj.weight"].t(), prec)
        y = F.layer_norm(x, (d,), P[p + "ln2.weight"], P[p + "ln2.bias"], eps)
        y = _gelu_tanh(_matmul(y, P[p + "up.weight"].t(), prec)
                       + P[p + "up.bias"])
        x = x + _matmul(y, P[p + "down.weight"].t(), prec) \
            + P[p + "down.bias"]
    y = F.layer_norm(x, (d,), P["lmhead.lnf.weight"], P["lmhead.lnf.bias"],
                     eps)
    logits = _matmul(y, P["lmhead.head.weight"].t(), prec)
    return torch.logsumexp(logits, -1) \
        - logits.gather(-1, targets.long()[..., None])[..., 0]


def _blocks(n: int, rows: int) -> List[Tuple[int, int]]:
    return [(lo, min(n, lo + rows)) for lo in range(0, n, rows)]


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.detach(),
                                              dtype=torch.float64))
            for k, t in tensors.items()}


def train(model: Dict, make_params, batches: Sequence[Tuple], lr: float,
          rows: int, prec: str = "f32", group=None
          ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """Adam from the weights ``make_params()`` over ``batches`` (this
    rank's (tokens, targets) of each step): (each step's mean loss, each
    leaf's first-gradient norm, each leaf's change norm after the last
    step). With ``group`` (a ``torch.distributed`` group) the loss and
    gradients are summed over its ranks, each holding as many tokens, and
    the mean is over all their tokens. The gradient of each step is
    accumulated ``rows`` rows at a time."""
    import torch.distributed as dist

    world = 1 if group is None else dist.get_world_size(group)
    P = {k: v.detach().requires_grad_() for k, v in make_params().items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    v2 = {k: torch.zeros_like(v) for k, v in P.items()}
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    with exact_matmuls():
        for t, (tok, tgt) in enumerate(batches, start=1):
            count = tok.numel() * world
            total = torch.zeros((), dtype=torch.float64, device=tok.device)
            for lo, hi in _blocks(tok.shape[0], rows):
                part = nll(P, model, tok[lo:hi], tgt[lo:hi], prec).sum()
                (part / count).backward()
                total += part.detach().double()
            if group is not None:
                flat = torch.cat([p.grad.reshape(-1) for p in P.values()])
                dist.all_reduce(flat, group=group)
                dist.all_reduce(total, group=group)
                off = 0
                for p in P.values():
                    p.grad.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()
                del flat
            losses.append(float(total) / count)
            if t == 1:
                grad1 = leaf_norms({k: p.grad for k, p in P.items()})
            with torch.no_grad():
                c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
                for k, p in P.items():
                    g = p.grad
                    m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    v2[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                    denom = (v2[k].sqrt() / math.sqrt(c2)).add_(ADAM_EPS)
                    p.addcdiv_(m[k], denom, value=-lr / c1)
                    p.grad = None
    del m, v2
    p0 = make_params()
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            P[k].detach() - p0[k], dtype=torch.float64)) for k in P}
    return losses, grad1, change


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   keep: Optional[Sequence[str]] = None
                   ) -> Tuple[float, str]:
    """(gap, leaf) of the leaf whose norms differ most: |prog - ref|
    against the larger of the reference's norm of that leaf and of the
    median leaf. ``keep`` limits the leaves compared."""
    names = list(ref) if keep is None else list(keep)
    med = float(torch.tensor([ref[k] for k in ref],
                             dtype=torch.float64).median())
    worst, where = 0.0, ""
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
        if gap > worst or not where:
            worst, where = gap, k
    return worst, where


def moving_leaves(grad1: Dict[str, float], share: float = 1e-3
                  ) -> List[str]:
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's: the others move under Adam by
    round-off alone."""
    med = float(torch.tensor(list(grad1.values()),
                             dtype=torch.float64).median())
    return [k for k, g in grad1.items() if g >= share * med]
