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
card, their plain versions on the CPU. With a ``mesh`` whose ``sp`` axis
is larger than 1 the model runs on this rank's sequence chunk and its
attention is :func:`~ddstore_tpu_torch.parallel.ring_attention.
ring_attention` over that axis. ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``), optionally saving what
``remat_policy`` names. :func:`make_train_step` is the reference's Adam
step with optional gradient accumulation, and over a mesh the dp x sp
step: one all-reduce of the gradients over the world after the backward.
MoE, tensor and pipeline parallelism are later slices and raise here.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.attention import flash_attention
from ..ops.xent import fused_linear_xent
from ..parallel.mesh import axis_size
from ..parallel.ring_attention import ring_attention

__all__ = ["Block", "EmbedPE", "LMHead", "TransformerLM", "loss_fn",
           "lm_loss", "TrainState", "create_train_state", "make_train_step",
           "REMAT_POLICIES", "param_digest", "broadcast_parameters",
           "all_reduce_gradients"]

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

    def forward(self, x: torch.Tensor, mesh=None, sp_axis: str = "sp"
                ) -> Tuple[torch.Tensor, KV]:
        """Returns the block output and this layer's (k, v) heads.

        Attention is ``flash_attention``: the kernels on the card, the
        plain versions on the CPU, differentiable on both. A length that
        is not a multiple of 8 is right-padded to one, and cut back after:
        under the causal mask the padded keys come after every real query,
        so the real rows are exact, and the gradient of the cut flows back
        through the pad as zeros.

        With ``mesh`` (``sp_axis`` larger than 1), ``x`` is this rank's
        sequence chunk and attention is ``ring_attention`` over the axis,
        unpadded: its chunks must be multiples of 8, as the reference's
        kernel needs."""
        if axis_size(mesh, sp_axis) > 1:
            if x.shape[1] % 8:
                raise ValueError(f"ring attention needs sequence chunks "
                                 f"that are multiples of 8, got "
                                 f"{x.shape[1]}")
            q, k, v = self.qkv_heads(x)
            out, _ = ring_attention(q, k, v, mesh=mesh, axis=sp_axis,
                                    causal=True)
            return self.finish(x, out), (k, v)
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


# The jax.checkpoint_policies names with an op-level counterpart in
# torch's selective checkpointing: the products each one saves (JAX's
# "dots" are dot_generals; those "with no batch dims" are the Dense
# layers' 2-D products, not attention's batched ones). The other JAX
# policies name values (offloading, named checkpoints) that have none.
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
REMAT_POLICIES = {
    "everything_saveable": None,  # saves all: the model checkpoints nothing
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
}

# Mesh axes of the parallel layers still to come, and their ROADMAP items.
_UNPORTED_AXES = {"tp": 14, "ep": 14, "fsdp": 14, "pp": 15}


def _refuse_unported_axes(mesh) -> None:
    for axis, item in _UNPORTED_AXES.items():
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"a mesh with a {axis!r} axis of size > 1 needs ROADMAP "
                f"item {item}, which is not ported yet (dp and sp are)")


def _remat_context_fn(policy: Optional[str]):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for ``policy``:
    ``None`` for a plain checkpoint (everything recomputed), else the
    selective contexts that save the outputs of the policy's products."""
    if not policy or policy == "nothing_saveable":
        return None
    saved = REMAT_POLICIES[policy]
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    ops = {getattr(torch.ops.aten, name).default for name in saved}

    def policy_fn(ctx, func, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if func in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts,
                             policy_fn)


def _block_out(blk: "Block", x, mesh, sp_axis):
    return blk(x, mesh, sp_axis)[0]


class TransformerLM(nn.Module):
    """Causal LM: ``forward(tokens, positions)`` on (B, S) int tensors ->
    (B, S, vocab) f32 logits.

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    path. Parameters are f32; ``compute_dtype`` is the activation dtype.

    ``mesh`` (a :func:`~ddstore_tpu_torch.parallel.mesh.make_mesh` mesh
    with ``dp`` and ``sp`` axes) switches attention to ring attention over
    ``sp_axis`` when that axis is larger than 1; the model then runs on
    this rank's ``(B/dp, S/sp)`` tokens with their global positions.
    ``remat`` recomputes every block in the backward; ``remat_policy``
    names what it saves instead, one of ``REMAT_POLICIES``
    (``everything_saveable`` saves all, so it turns ``remat`` off).
    """

    def __init__(self, vocab: int = 1024, dim: int = 256, heads: int = 8,
                 layers: int = 4, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None, sp_axis: str = "sp",
                 n_experts: int = 0, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        if n_experts > 0:
            raise NotImplementedError("MoE blocks need ROADMAP item 13, "
                                      "which is not ported yet")
        _refuse_unported_axes(mesh)
        if remat and remat_policy and remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy {remat_policy!r} has no counterpart in the "
                f"port; valid: {sorted(REMAT_POLICIES)}")
        device = resolve_device(device)
        self.vocab, self.dim, self.heads, self.layers = vocab, dim, heads, \
            layers
        self.mlp_ratio = mlp_ratio
        self.compute_dtype = compute_dtype
        self.mesh, self.sp_axis = mesh, sp_axis
        self.remat = bool(remat) and remat_policy != "everything_saveable"
        self.remat_policy = remat_policy
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
        heads (B, H, S, hd), which seed the decode cache.

        Under ``remat``, with gradients enabled and no ``return_kv``, each
        block runs under ``torch.utils.checkpoint`` (non-reentrant): its
        activations are recomputed in the backward, ring shifts
        included, save what ``remat_policy`` keeps."""
        remat = self.remat and torch.is_grad_enabled() and not return_kv
        ctx_fn = _remat_context_fn(self.remat_policy) if remat else None
        x = self.embed(tokens, positions)
        kvs: List[KV] = []
        for blk in self.blocks:
            if remat:
                kw = {} if ctx_fn is None else {"context_fn": ctx_fn}
                x = checkpoint(_block_out, blk, x, self.mesh, self.sp_axis,
                               use_reentrant=False, **kw)
                continue
            x, kv = blk(x, self.mesh, self.sp_axis)
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


def param_digest(model: nn.Module) -> str:
    """sha256 of the model's parameters' bytes, in order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def broadcast_parameters(model: nn.Module, src: int = 0,
                         group=None) -> None:
    """Overwrite every rank's parameters with rank ``src``'s, in one
    broadcast of their flattened f32 values (for weights restored on one
    rank). A collective."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    dist.broadcast(flat, src, group=group)
    off = 0
    for p in params:
        p.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()


def create_train_state(model: nn.Module, lr: float = 3e-4, mesh=None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Adam over the model's parameters with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8 added outside the square root, no weight decay), as
    ``optax.adam(lr)`` at ``transformer.py:315``; returns (state, opt)
    like the reference's (state, tx).

    With ``mesh`` (dp and sp axes) the parameters are replicated, as the
    reference's ``rules = P()`` branch places them (``:339``): every rank
    has drawn them from the same seed, and a digest of them is checked
    equal over the world (``ValueError`` where it is not; weights
    restored on one rank reach the others by :func:`broadcast_parameters`
    first)."""
    if mesh is not None:
        _refuse_unported_axes(mesh)
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, param_digest(model))
        if len(set(digests)) != 1:
            raise ValueError("the ranks' parameters differ; draw them from "
                             "one seed or broadcast_parameters() first")
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=0.0)
    return TrainState(model, opt), opt


@torch.no_grad()
def all_reduce_gradients(params: List[nn.Parameter], world: int) -> None:
    """One all-reduce of the flattened f32 gradients over the default
    group, then each gradient set to the sum divided by ``world`` (a
    missing gradient counts as 0). A collective."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat.div_(world)
    off = 0
    for p in params:
        n = p.numel()
        if p.grad is None:
            p.grad = torch.empty_like(p)
        p.grad.copy_(flat[off:off + n].view_as(p))
        off += n


def make_train_step(model: TransformerLM, opt: torch.optim.Optimizer,
                    fused_xent: Optional[bool] = None,
                    accum_steps: int = 1,
                    state: Optional[TrainState] = None, mesh=None
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

    With ``mesh`` (dp and sp axes; the reference's ``P(dp, sp)`` step,
    ``:400-422``) each rank passes its own ``(B/dp, S/sp)`` tokens,
    targets and global positions; its loss is the mean over its tokens.
    After the backward (the last chunk's, under ``accum_steps``) one
    all-reduce of the flattened f32 gradients over the whole world,
    divided by the world size, gives every rank the gradient of the
    global token mean (the chunks are equal), and the returned loss is
    all-reduced the same way, so every rank reports the reference's
    replicated scalar. ``mesh`` defaults to ``model.mesh``, whose ring
    carries the sequence axis; a mesh that splits the sequence (``sp`` >
    1) but is not the model's raises ``ValueError``, since the model would
    then attend within each rank's chunk alone. The gradient reduction
    runs on the default group, after the ring's last backward shift.
    """
    if mesh is None:
        mesh = model.mesh
    elif mesh is not model.mesh and axis_size(mesh, model.sp_axis) > 1:
        raise ValueError(
            f"make_train_step's mesh splits the sequence over "
            f"{model.sp_axis!r}, but the model's ring runs over "
            f"model.mesh ({model.mesh!r}); build the model with this mesh")
    if mesh is not None:
        _refuse_unported_axes(mesh)
    world = dist.get_world_size() if mesh is not None else 1
    params = list(model.parameters())

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
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            loss = loss / accum_steps
        loss = loss.detach()
        if mesh is not None:
            all_reduce_gradients(params, world)
            loss = loss.float().clone()
            dist.all_reduce(loss)
            loss = loss / world
        opt.step()
        if state is not None:
            state.step += 1
        return loss

    return step
