"""Decoder-only transformer LM and its train step (the port of
``ddstore_tpu/models/transformer.py:38-422``, dense and sequential).

Numerics follow the flax reference:

* LayerNorm runs in f32 with eps 1e-6 and is then cast to
  ``compute_dtype``;
* the ``qkv``, ``proj``, ``up`` and ``down`` projections keep f32
  parameters and compute in ``compute_dtype``; the vocab head is f32;
* GELU is the tanh approximation;
* the sinusoidal position encoding is built in f32 and cast.

Attention in :class:`Block` is :func:`~ddstore_tpu_torch.ops.attention.
flash_attention` at every length (one that is not a multiple of 8 is
padded for it and cut back): the forward and backward kernels on the
card, their plain versions on the CPU. :func:`make_train_step` is the
reference's Adam step with optional gradient accumulation. Ring
attention, MoE and rematerialization are later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.attention import flash_attention
from ..ops.xent import fused_linear_xent

__all__ = ["Block", "EmbedPE", "LMHead", "TransformerLM", "loss_fn",
           "lm_loss", "TrainState", "create_train_state", "make_train_step"]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)

KV = Tuple[torch.Tensor, torch.Tensor]


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype
           ) -> torch.Tensor:
    """A flax ``Dense(dtype=dt)``: f32 parameters, computed in ``dt``."""
    bias = None if lin.bias is None else lin.bias.to(dt)
    y = F.linear(x.to(dt), lin.weight.to(dt))
    return y if bias is None else y + bias


class Block(nn.Module):
    """Pre-LN attention + MLP block. The step is split into
    :meth:`qkv_heads` and :meth:`finish` so that the KV-cached decode
    step (``decode.decode_step``) runs the same layer math around its own
    attention."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.compute_dtype = compute_dtype
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.proj = nn.Linear(dim, dim, bias=False, device=device)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.up = nn.Linear(dim, mlp_ratio * dim, device=device)
        self.down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def qkv_heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, S, dim) -> q, k, v as (B, H, S, hd) views of one
        projection (the kernel reads them in place by stride)."""
        b, s, _ = x.shape
        dt = self.compute_dtype
        h = _layer_norm(self.ln1, x).to(dt)
        qkv = _dense(self.qkv, h, dt)
        hd = self.dim // self.heads
        return tuple(t.reshape(b, s, self.heads, hd).transpose(1, 2)
                     for t in qkv.split(self.dim, dim=-1))

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Residual projection of the attention output (B, H, S, hd),
        then the MLP."""
        b, s, _ = x.shape
        dt = self.compute_dtype
        out = attn.transpose(1, 2).reshape(b, s, self.dim).to(dt)
        x = x + _dense(self.proj, out, dt)
        h = _layer_norm(self.ln2, x).to(dt)
        h = F.gelu(_dense(self.up, h, dt), approximate="tanh")
        return x + _dense(self.down, h, dt)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, KV]:
        """Returns the block output and this layer's (k, v) heads.

        Attention is ``flash_attention``: the kernels on the card, the
        plain versions on the CPU, differentiable on both. A length that
        is not a multiple of 8 is right-padded to one, and cut back after:
        under the causal mask the padded keys come after every real query,
        so the real rows are exact, and the gradient of the cut flows back
        through the pad as zeros."""
        s = x.shape[1]
        pad = -s % 8
        q, k, v = self.qkv_heads(F.pad(x, (0, 0, 0, pad)) if pad else x)
        out, _ = flash_attention(q, k, v, causal=True)
        if pad:
            out, k, v = out[:, :, :s], k[:, :, :s], v[:, :, :s]
        return self.finish(x, out), (k, v)


class EmbedPE(nn.Module):
    """Token embedding + fixed sinusoidal positions (global positions, so
    any context length works)."""

    def __init__(self, vocab: int, dim: int, compute_dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.dim = dim
        self.compute_dtype = compute_dtype
        self.tok = nn.Embedding(vocab, dim, device=device)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.embedding(tokens.long(), self.tok.weight).to(dt)
        half = self.dim // 2
        ar = torch.arange(half, dtype=torch.float32, device=tokens.device)
        freqs = torch.exp(-math.log(10000.0) * ar / half)
        ang = positions[..., None].float() * freqs
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return x + pe.to(dt)


class LMHead(nn.Module):
    """Final LayerNorm + f32 vocab projection. ``features_only=True``
    stops after the LayerNorm (the fused cross-entropy and the decode
    prefill apply ``head`` themselves)."""

    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.lnf = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.head = nn.Linear(dim, vocab, bias=False, device=device)

    def forward(self, x: torch.Tensor, features_only: bool = False
                ) -> torch.Tensor:
        x = _layer_norm(self.lnf, x)
        if features_only:
            return x
        return F.linear(x, self.head.weight.float())


class TransformerLM(nn.Module):
    """Causal LM: ``forward(tokens, positions)`` on (B, S) int tensors ->
    (B, S, vocab) f32 logits.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    path. Parameters are f32; ``compute_dtype`` is the activation dtype.
    """

    def __init__(self, vocab: int = 1024, dim: int = 256, heads: int = 8,
                 layers: int = 4, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None, n_experts: int = 0,
                 remat: bool = False):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError("ring attention (mesh) is not ported "
                                      "yet")
        if n_experts > 0:
            raise NotImplementedError("MoE blocks are not ported yet")
        if remat:
            raise NotImplementedError("remat is not ported yet")
        device = resolve_device(device)
        self.vocab, self.dim, self.heads, self.layers = vocab, dim, heads, \
            layers
        self.mlp_ratio = mlp_ratio
        self.compute_dtype = compute_dtype
        self.embed = EmbedPE(vocab, dim, compute_dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, compute_dtype, device=device)
            for _ in range(layers))
        self.lmhead = LMHead(vocab, dim, device=device)

    @property
    def device(self) -> torch.device:
        return self.lmhead.head.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights from ``generator`` (made on the generator's
        device), with the reference's init scales: embeddings and Dense
        kernels ~ N(0, 1/fan_in), biases 0, LayerNorm scale 1 and bias
        0."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:  # LayerNorm scale
                p.fill_(1.0)
            else:
                fan_in = p.shape[1]  # Linear (out, in); Embedding (V, dim)
                r = torch.randn(p.shape, generator=generator,
                                device=generator.device)
                p.copy_(r / math.sqrt(fan_in))
        return self

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                return_features: bool = False, return_kv: bool = False):
        """``return_features`` returns the post-final-LayerNorm features
        instead of logits; ``return_kv`` also returns each layer's (k, v)
        heads (B, H, S, hd), which seed the decode cache."""
        x = self.embed(tokens, positions)
        kvs: List[KV] = []
        for blk in self.blocks:
            x, kv = blk(x)
            if return_kv:
                kvs.append(kv)
        out = self.lmhead(x, return_features)
        return (out, kvs) if return_kv else out


def loss_fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (targets are pre-shifted)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            targets: torch.Tensor, positions: torch.Tensor, *,
            fused_xent: Optional[bool] = None,
            xent_block: int = 8192) -> torch.Tensor:
    """The LM loss, differentiable (the shared path of
    :func:`make_train_step` and evaluation; eval callers wrap it in
    ``torch.no_grad()``). ``fused_xent`` streams the head through
    :func:`~ddstore_tpu_torch.ops.xent.fused_linear_xent` (matmul in
    ``compute_dtype``, f32 accumulation) so the logits never materialize
    in the forward or the backward; ``None`` enables it at
    ``vocab >= 2 * xent_block``, as the reference does."""
    if fused_xent is None:
        fused_xent = model.vocab >= 2 * xent_block
    out = model(tokens, positions, return_features=fused_xent)
    if not fused_xent:
        return loss_fn(out, targets)
    nll = fused_linear_xent(
        out.reshape(-1, out.shape[-1]).to(model.compute_dtype),
        model.lmhead.head.weight.t(), targets.reshape(-1), xent_block,
        model.compute_dtype)
    return nll.mean()


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState`` (params, opt_state, step): here the
    model holds the parameters and the optimizer its state, both updated
    in place by the step; ``step`` counts the updates made through it."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, lr: float = 3e-4
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Adam over the model's parameters with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8 added outside the square root, no weight decay), as
    ``optax.adam(lr)`` at ``transformer.py:315``; returns (state, opt)
    like the reference's (state, tx)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    return TrainState(model, opt), opt


def make_train_step(model: TransformerLM, opt: torch.optim.Optimizer,
                    fused_xent: Optional[bool] = None,
                    accum_steps: int = 1,
                    state: Optional[TrainState] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor,
                                   torch.Tensor], torch.Tensor]:
    """The train step over ``(tokens, targets, positions)``, all (B, S):
    the loss of :func:`lm_loss`, its gradients, one ``opt`` update.
    Returns the step, which returns the loss (f32, detached).

    The parameters and the optimizer state are updated in place: that is
    the counterpart of the reference's donated state (``donate=True``),
    whose buffers the step reuses. Pass ``state`` to have its ``step``
    advanced.

    ``accum_steps > 1`` is gradient accumulation (``transformer.py:
    374-399``): the batch splits into that many equal chunks, each runs
    forward and backward, the f32 gradients are summed and divided by
    ``accum_steps``, and one update applies them; the loss is the mean of
    the chunk losses. A batch that does not divide raises ``ValueError``.
    """

    def lossf(tok, tgt, pos):
        return lm_loss(model, tok, tgt, pos, fused_xent=fused_xent)

    def step(tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = lossf(tokens, targets, positions)
            loss.backward()
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(f"batch {tokens.shape[0]} not divisible "
                                 f"by accum_steps {accum_steps}")
            # The f32 parameters' .grad sums the chunks' gradients.
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            for chunk in zip(*(t.chunk(accum_steps) for t in
                               (tokens, targets, positions))):
                part = lossf(*chunk)
                part.backward()
                loss = loss + part.detach()
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            loss = loss / accum_steps
        opt.step()
        if state is not None:
            state.step += 1
        return loss.detach()

    return step
