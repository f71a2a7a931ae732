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
step: one all-reduce of the gradients over the data ranks after the
backward.

``n_experts > 0`` swaps each block's MLP for a top-k
:class:`~ddstore_tpu_torch.models.moe.MoeMlp`, and :func:`lm_loss` adds
``MOE_AUX_WEIGHT`` times the layers' mean aux. :func:`create_train_state`
over a mesh with ``tp``, ``ep`` or ``fsdp`` axes places the parameters by
the reference's rules (``parallel.tp``, ``parallel.fsdp``): tensor and
expert shards as DTensors, ZeRO-3 through FSDP2. The layers compute on
their local shards and take their collectives from their parameters'
placements; the head, vocab-sharded under tp, gets a vocab-parallel
cross-entropy. Pipeline parallelism is a later slice and raises.
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
from ..parallel.collectives import (all_reduce, copy_to_group,
                                    reduce_from_group)
from ..parallel.mesh import axes_group, axis_size
from ..parallel.ring_attention import ring_attention
from .moe import MoeMlp, _axis_of, _local, init_expert_

__all__ = ["Block", "EmbedPE", "LMHead", "TransformerLM", "loss_fn",
           "lm_loss", "MOE_AUX_WEIGHT", "moe_aux_sum", "TrainState",
           "create_train_state", "make_train_step", "REMAT_POLICIES",
           "param_digest", "broadcast_parameters", "all_reduce_gradients",
           "unshard"]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)

KV = Tuple[torch.Tensor, torch.Tensor]


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype
           ) -> torch.Tensor:
    """A flax ``Dense(dtype=dt)``: f32 parameters, computed in ``dt``.
    A weight sharded on its output dim (column-parallel) computes this
    rank's columns, its input's gradient summed over the shard's axis."""
    w = lin.weight
    x = copy_to_group(x.to(dt), _axis_of(w, 0)[0])
    y = F.linear(x, _local(w).to(dt))
    return y if lin.bias is None else y + _local(lin.bias).to(dt)


def _row_dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype
               ) -> torch.Tensor:
    """``_dense`` for a weight sharded on its input dim (row-parallel):
    the partial products summed over the shard's axis in f32 and rounded
    once, then the (replicated) bias."""
    y = F.linear(x.to(dt), _local(lin.weight).to(dt))
    group = _axis_of(lin.weight, 1)[0]
    if group is not None:
        y = reduce_from_group(y.float(), group).to(dt)
    return y if lin.bias is None else y + lin.bias.to(dt)


class Block(nn.Module):
    """Pre-LN attention + MLP (or MoE) block. The step is split into
    :meth:`qkv_heads`, :meth:`attend_out` and :meth:`mlp` so that the
    KV-cached decode step (``decode.decode_step``) runs the same layer
    math around its own attention.

    Under tensor parallelism (``qkv`` sharded by heads over ``tp``) the
    block runs this rank's ``H / tp`` heads and MLP columns: ``qkv`` and
    ``up`` are column-parallel, ``proj`` and ``down`` row-parallel, as
    Megatron's blocks are."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int,
                 compute_dtype: torch.dtype, device=None,
                 n_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity: Optional[int] = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.compute_dtype = compute_dtype
        self.n_experts = n_experts
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
        self.proj = nn.Linear(dim, dim, bias=False, device=device)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        if n_experts > 0:
            self.moe = MoeMlp(dim, n_experts, mlp_ratio * dim,
                              top_k=moe_top_k, capacity=moe_capacity,
                              compute_dtype=compute_dtype, device=device)
        else:
            self.up = nn.Linear(dim, mlp_ratio * dim, device=device)
            self.down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def qkv_heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, S, dim) -> q, k, v as (B, H, S, hd) views of one
        projection (the kernel reads them in place by stride); ``H`` is
        this rank's heads under tensor parallelism."""
        b, s, _ = x.shape
        dt = self.compute_dtype
        h = _layer_norm(self.ln1, x).to(dt)
        qkv = _dense(self.qkv, h, dt)
        hd = self.dim // self.heads
        width = qkv.shape[-1] // 3
        return tuple(t.reshape(b, s, width // hd, hd).transpose(1, 2)
                     for t in qkv.split(width, dim=-1))

    def attend_out(self, x: torch.Tensor, attn: torch.Tensor
                   ) -> torch.Tensor:
        """The residual projection of the attention output (B, H, S,
        hd)."""
        b, s, _ = x.shape
        out = attn.transpose(1, 2).reshape(b, s, -1)
        return x + _row_dense(self.proj, out, self.compute_dtype)

    def mlp(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
            moe_capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The MLP (or MoE) residual: (x, the MoE's aux or None).
        ``valid`` (B*S,) bool and ``moe_capacity`` reach the MoE's
        routing."""
        b, s, _ = x.shape
        dt = self.compute_dtype
        h = _layer_norm(self.ln2, x).to(dt)
        if self.n_experts > 0:
            y, aux = self.moe(h.reshape(b * s, self.dim), valid,
                              moe_capacity)
            return x + y.reshape(b, s, self.dim).to(dt), aux
        h = F.gelu(_dense(self.up, h, dt), approximate="tanh")
        return x + _row_dense(self.down, h, dt), None

    def forward(self, x: torch.Tensor, mesh=None, sp_axis: str = "sp",
                valid: Optional[torch.Tensor] = None,
                moe_capacity: Optional[int] = None
                ) -> Tuple[torch.Tensor, KV, Optional[torch.Tensor]]:
        """Returns the block output, this layer's (k, v) heads and the
        MoE's aux (None for a dense block).

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
        else:
            s = x.shape[1]
            pad = -s % 8
            q, k, v = self.qkv_heads(F.pad(x, (0, 0, 0, pad)) if pad
                                     else x)
            out, _ = flash_attention(q, k, v, causal=True)
            if pad:
                out, k, v = out[:, :, :s], k[:, :, :s], v[:, :, :s]
        x, aux = self.mlp(self.attend_out(x, out), valid, moe_capacity)
        return x, (k, v), aux


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
_UNPORTED_AXES = {"pp": 15}
# The data axes of a step: their ranks hold different tokens (those of
# tp and ep hold the same).
DATA_AXES = ("dp", "sp", "fsdp")


def _refuse_unported_axes(mesh) -> None:
    for axis, item in _UNPORTED_AXES.items():
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"a mesh with a {axis!r} axis of size > 1 needs ROADMAP "
                f"item {item}, which is not ported yet (dp, sp, tp, ep and "
                f"fsdp are)")


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


def _block_out(blk: "Block", x, mesh, sp_axis, valid, moe_capacity):
    x, _, aux = blk(x, mesh, sp_axis, valid, moe_capacity)
    return x if aux is None else (x, aux)


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

    ``n_experts > 0`` makes every block's MLP a top-``moe_top_k`` MoE
    with ``moe_capacity`` slots an expert (None: ``default_capacity``);
    after each forward ``moe_aux`` holds the layers' aux losses. Under a
    mesh with ``sp`` larger than 1 the MoE refuses (routing over a split
    sequence is not ported).
    """

    def __init__(self, vocab: int = 1024, dim: int = 256, heads: int = 8,
                 layers: int = 4, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None, sp_axis: str = "sp",
                 n_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity: Optional[int] = None, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        _refuse_unported_axes(mesh)
        if n_experts > 0 and axis_size(mesh, sp_axis) > 1:
            raise NotImplementedError(
                "MoE over a mesh that splits the sequence (sp x ep routing "
                "in the global token order) is not ported (ROADMAP.md "
                "queue A)")
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
        self.n_experts, self.moe_top_k = n_experts, moe_top_k
        self.moe_capacity = moe_capacity
        self.moe_aux: List[torch.Tensor] = []
        self.remat = bool(remat) and remat_policy != "everything_saveable"
        self.remat_policy = remat_policy
        self.embed = EmbedPE(vocab, dim, compute_dtype, device=device)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, compute_dtype, device=device,
                  n_experts=n_experts, moe_top_k=moe_top_k,
                  moe_capacity=moe_capacity)
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
        0; the experts' ``w1``/``w2`` as flax's ``lecun_normal`` scales an
        ``(E, in, out)`` kernel, fan-in ``E * in``."""
        for name, p in self.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf in ("bias", "b1", "b2"):
                p.zero_()
            elif p.ndim == 1:  # LayerNorm scale
                p.fill_(1.0)
            elif leaf in ("w1", "w2"):
                init_expert_(p, generator)
            else:
                fan_in = p.shape[1]  # Linear (out, in); Embedding (V, dim)
                r = torch.randn(p.shape, generator=generator,
                                device=generator.device)
                p.copy_(r / math.sqrt(fan_in))
        return self

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                return_features: bool = False, return_kv: bool = False, *,
                token_mask: Optional[torch.Tensor] = None,
                moe_capacity: Optional[int] = None,
                targets: Optional[torch.Tensor] = None,
                fused_xent: bool = False, xent_block: int = 8192):
        """``return_features`` returns the post-final-LayerNorm features
        instead of logits; ``return_kv`` also returns each layer's (k, v)
        heads (B, H, S, hd), which seed the decode cache. ``targets``
        (B, S) returns instead each token's f32 negative log-likelihood
        (the loss inside the forward, so that a fully-sharded head is
        whole while it runs), through the fused cross-entropy when
        ``fused_xent``.

        ``token_mask`` (B, S) bool marks real tokens: only MoE routing
        reads it (padded ones take no capacity); ``moe_capacity``
        overrides the experts' capacity for this call.

        Under ``remat``, with gradients enabled and no ``return_kv``, each
        block runs under ``torch.utils.checkpoint`` (non-reentrant): its
        activations are recomputed in the backward, ring shifts
        included, save what ``remat_policy`` keeps."""
        remat = self.remat and torch.is_grad_enabled() and not return_kv
        ctx_fn = _remat_context_fn(self.remat_policy) if remat else None
        valid = None if token_mask is None else token_mask.reshape(-1)
        x = self.embed(tokens, positions)
        kvs: List[KV] = []
        aux: List[torch.Tensor] = []
        for blk in self.blocks:
            if remat:
                kw = {} if ctx_fn is None else {"context_fn": ctx_fn}
                out = checkpoint(_block_out, blk, x, self.mesh,
                                 self.sp_axis, valid, moe_capacity,
                                 use_reentrant=False, **kw)
                x, a = out if isinstance(out, tuple) else (out, None)
            else:
                x, kv, a = blk(x, self.mesh, self.sp_axis, valid,
                               moe_capacity)
                if return_kv:
                    kvs.append(kv)
            if a is not None:
                aux.append(a)
        self.moe_aux = aux
        if targets is not None:
            return self._nll(x, targets, fused_xent, xent_block)
        out = self.lmhead(x, return_features)
        return (out, kvs) if return_kv else out

    def head_is_sharded(self) -> bool:
        """Whether the vocab head is split over ranks (tensor
        parallelism)."""
        return _axis_of(self.lmhead.head.weight, 0)[0] is not None

    def _nll(self, x: torch.Tensor, targets: torch.Tensor, fused: bool,
             xent_block: int) -> torch.Tensor:
        feats = self.lmhead(x, features_only=True)
        w = self.lmhead.head.weight
        group, idx = _axis_of(w, 0)
        if group is not None:
            if fused:
                raise ValueError("the fused cross-entropy needs the whole "
                                 "vocab head; a tensor-parallel head is "
                                 "vocab-sharded (pass fused_xent=False)")
            return _vocab_parallel_nll(feats, _local(w), targets, group,
                                       idx)
        if not fused:
            logp = torch.log_softmax(F.linear(feats, w.float()), dim=-1)
            return -logp.gather(-1, targets.long()[..., None])[..., 0]
        nll = fused_linear_xent(
            feats.reshape(-1, feats.shape[-1]).to(self.compute_dtype),
            w.t(), targets.reshape(-1), xent_block, self.compute_dtype)
        return nll.view(targets.shape)


def _vocab_parallel_nll(feats: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor, group, idx: int
                        ) -> torch.Tensor:
    """Each token's f32 negative log-likelihood under a head whose vocab
    is split over ``group`` (this rank holds rows ``[idx * V/n, (idx + 1)
    * V/n)`` of the ``(V, dim)`` weight ``w``): the max and the sum of
    exponentials over the whole vocab, and the target's logit from the
    rank that holds it, each one reduction over the group."""
    feats = copy_to_group(feats, group)
    logits = F.linear(feats, w.float())
    vl = w.shape[0]
    m = all_reduce(logits.detach().amax(-1), group, dist.ReduceOp.MAX)
    sumexp = reduce_from_group(torch.exp(logits - m[..., None]).sum(-1),
                               group)
    t = targets.long() - idx * vl
    inside = (t >= 0) & (t < vl)
    tl = logits.gather(-1, t.clamp(0, vl - 1)[..., None])[..., 0]
    tl = reduce_from_group(torch.where(inside, tl, torch.zeros_like(tl)),
                           group)
    return torch.log(sumexp) + m - tl


# The weight of the MoE load-balancing aux in the LM loss (the
# reference's MOE_AUX_WEIGHT, transformer.py:206).
MOE_AUX_WEIGHT = 0.01


def loss_fn(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (targets are pre-shifted)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def moe_aux_sum(model: TransformerLM) -> torch.Tensor:
    """The sum of the MoE layers' aux losses of the model's last forward
    (0 for a dense model)."""
    if not model.moe_aux:
        return torch.zeros((), dtype=torch.float32, device=model.device)
    return torch.stack(model.moe_aux).sum()


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
    ``vocab >= 2 * xent_block`` unless the head is vocab-sharded (tensor
    parallelism), as the reference does. An MoE model adds
    ``MOE_AUX_WEIGHT`` times its layers' mean aux."""
    if fused_xent is None:
        fused_xent = model.vocab >= 2 * xent_block \
            and not model.head_is_sharded()
    nll = model(tokens, positions, targets=targets, fused_xent=fused_xent,
                xent_block=xent_block)
    loss = nll.mean()
    if model.n_experts > 0:
        loss = loss + MOE_AUX_WEIGHT * moe_aux_sum(model) / model.layers
    return loss


@dataclasses.dataclass
class TrainState:
    """The reference's ``TrainState`` (params, opt_state, step): here the
    model holds the parameters and the optimizer its state, both updated
    in place by the step; ``step`` counts the updates made through it.
    ``mesh`` is the mesh the parameters were placed over (None:
    unplaced)."""

    model: nn.Module
    opt: torch.optim.Optimizer
    step: int = 0
    mesh: object = None


def param_digest(model: nn.Module) -> str:
    """sha256 of the model's parameters' bytes (this rank's shards), in
    order."""
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(_local(p.detach()).cpu().numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def broadcast_parameters(model: nn.Module, src: int = 0,
                         group=None) -> None:
    """Overwrite every rank's parameters with rank ``src``'s, in one
    broadcast of their flattened f32 values (for weights restored on one
    rank, before the model is placed). A collective."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    dist.broadcast(flat, src, group=group)
    off = 0
    for p in params:
        p.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()


def adam(params, lr: float) -> torch.optim.Optimizer:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root, no weight decay. Parameters are grouped by their mesh
    (plain tensors in one group), since one fused update cannot mix
    DTensors of different meshes with plain tensors."""
    groups = {}
    for p in params:
        mesh = getattr(p, "device_mesh", None)
        key = None if mesh is None else (mesh.mesh_dim_names,
                                         tuple(mesh.mesh.flatten().tolist()))
        groups.setdefault(key, []).append(p)
    return torch.optim.Adam([{"params": ps} for ps in groups.values()],
                            lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.0)


def _check_replicas(model: nn.Module) -> None:
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, param_digest(model))
    if len(set(digests)) != 1:
        raise ValueError("the ranks' parameters differ; draw them from "
                         "one seed or broadcast_parameters() first")


def _lm_rules(mesh):
    """The reference's rule choice (``transformer.py:322-346``): fsdp on
    top of the expert or Megatron rules when fsdp meets ep or tp, then ep,
    tp, fsdp alone; None when the parameters stay replicated."""
    from ..parallel.fsdp import fsdp_compose, fsdp_rules
    from ..parallel.tp import expert_rules, megatron_rules

    tp, ep, fsdp = (axis_size(mesh, a) > 1 for a in ("tp", "ep", "fsdp"))
    if fsdp and (tp or ep):
        base = expert_rules("ep", "tp" if tp else None) if ep \
            else megatron_rules("tp")
        return fsdp_compose(base, mesh)
    if ep:
        return expert_rules("ep", "tp" if tp else None)
    if tp:
        return megatron_rules("tp")
    if fsdp:
        return fsdp_rules(mesh)
    return None


def create_train_state(model: nn.Module, lr: float = 3e-4, mesh=None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Adam over the model's parameters with optax's defaults, as
    ``optax.adam(lr)`` at ``transformer.py:315``; returns (state, opt)
    like the reference's (state, tx).

    With ``mesh`` every rank holds the same full parameters (drawn from
    one seed; a digest of them is checked equal over the world,
    ``ValueError`` where it is not, and weights restored on one rank reach
    the others by :func:`broadcast_parameters` first), and they are
    placed by the reference's rules for the mesh's axes (``:322-346``):
    replicated over dp and sp; Megatron's over ``tp`` (``parallel.tp.
    megatron_rules``, q, k and v split by heads); the experts over ``ep``
    (``expert_rules``); ZeRO-3 over ``fsdp`` through FSDP2
    (``parallel.fsdp.place_zero3``), on top of the tp or ep placement when
    both are present. The MoE layers route over the mesh's data axes (dp
    and fsdp). The optimizer is made on the placed parameters, so its
    moments are sharded alike."""
    if mesh is not None:
        _refuse_unported_axes(mesh)
        if axis_size(mesh, "fsdp") > 1 and axis_size(mesh, "sp") > 1:
            raise NotImplementedError("fsdp with a sequence-parallel axis "
                                      "is not ported (ROADMAP.md queue A)")
        _check_replicas(model)
        if isinstance(model, TransformerLM):
            _place_lm(model, mesh)
        elif axis_size(mesh, "fsdp") > 1:
            raise ValueError("this model family places itself over fsdp: "
                             "use its own create_train_state")
    opt = adam(model.parameters(), lr)
    return TrainState(model, opt, mesh=mesh), opt


def _place_lm(model: TransformerLM, mesh) -> None:
    from ..parallel.fsdp import place_zero3
    from ..parallel.tp import shard_pytree

    if model.n_experts > 0:
        if model.n_experts % axis_size(mesh, "ep"):
            raise ValueError(f"{model.n_experts} experts do not split over "
                             f"ep={axis_size(mesh, 'ep')}")
        group = axes_group(mesh, ("dp", "fsdp"))
        for blk in model.blocks:
            blk.moe.route_group = group
    if model.heads % axis_size(mesh, "tp"):
        raise ValueError(f"{model.heads} heads do not split over "
                         f"tp={axis_size(mesh, 'tp')}")
    rules = _lm_rules(mesh)
    if rules is None:
        return
    if axis_size(mesh, "fsdp") > 1:
        place_zero3(model, mesh, rules, blocks=model.blocks)
    else:
        shard_pytree(model, mesh, rules)


@torch.no_grad()
def all_reduce_gradients(params: List[nn.Parameter], world: int,
                         group=None) -> None:
    """One all-reduce of the flattened f32 gradients (this rank's shards)
    over ``group`` (default: the world), then each gradient set to the
    sum divided by ``world`` (a missing gradient counts as 0). A
    collective."""
    if not params:
        return
    grads = [_local(p.grad) if p.grad is not None
             else torch.zeros_like(_local(p)) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(world)
    off = 0
    for p in params:
        n = _local(p).numel()
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        _local(p.grad).copy_(flat[off:off + n].view_as(_local(p)))
        off += n


def _fsdp_managed(p: torch.Tensor) -> bool:
    mesh = getattr(p, "device_mesh", None)
    return mesh is not None and "fsdp" in (mesh.mesh_dim_names or ())


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

    With ``mesh`` (the reference's step over ``P(("dp", "fsdp"), "sp")``,
    ``:400-422``) each rank passes its own ``(B/(dp*fsdp), S/sp)``
    tokens, targets and global positions (ranks along tp and ep pass the
    same ones); its loss is the mean over its tokens. After the backward
    (the last chunk's, under ``accum_steps``) the gradient of each
    parameter is averaged over the data ranks that hold the same shard of
    it: FSDP2's reduce-scatter for the fully-sharded ones, and one
    all-reduce of the others' flattened f32 gradients over the ``dp`` x
    ``sp`` x ``fsdp`` group, divided by its size. Never over ``tp`` or
    ``ep``: their ranks hold the same tokens, and the layers' own
    collectives have already made their replicated gradients whole. That
    gives every rank the gradient of the global token mean (the chunks
    are equal), and the returned loss is all-reduced over the world and
    divided by its size, so every rank reports the reference's
    replicated scalar. A mesh with ``tp``, ``ep`` or ``fsdp`` axes needs
    the ``state`` that :func:`create_train_state` placed over it
    (``ValueError`` otherwise, as ``:407-412``). ``mesh`` defaults to
    ``model.mesh``, whose ring carries the sequence axis; a mesh that
    splits the sequence (``sp`` > 1) but is not the model's raises
    ``ValueError``, since the model would then attend within each rank's
    chunk alone.
    """
    if mesh is None:
        mesh = model.mesh if state is None or state.mesh is None \
            else state.mesh
    if mesh is not model.mesh and axis_size(mesh, model.sp_axis) > 1:
        raise ValueError(
            f"make_train_step's mesh splits the sequence over "
            f"{model.sp_axis!r}, but the model's ring runs over "
            f"model.mesh ({model.mesh!r}); build the model with this mesh")
    if mesh is not None:
        _refuse_unported_axes(mesh)
        if any(axis_size(mesh, a) > 1 for a in ("tp", "ep", "fsdp")) and \
                (state is None or state.mesh is not mesh):
            raise ValueError("mesh has tp/ep/fsdp axes: pass the `state` "
                             "create_train_state placed over this mesh, "
                             "so the step keeps its parameters sharded")
    world = dist.get_world_size() if mesh is not None else 1
    params = list(model.parameters())
    reduced = [p for p in params if not _fsdp_managed(p)]
    data = axes_group(mesh, DATA_AXES)
    n_data = 1 if data is None else dist.get_world_size(data)

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
            if data is not None:
                all_reduce_gradients(reduced, n_data, data)
            loss = loss.float().clone()
            dist.all_reduce(loss)
            loss = loss / world
        opt.step()
        if state is not None:
            state.step += 1
        return loss

    return step


def unshard(model: TransformerLM, device=None) -> TransformerLM:
    """A plain copy of a placed model: the same configuration with no
    mesh (the ring mesh kept when it splits the sequence) and every
    parameter whole, on ``device`` (default the model's). A collective of
    the model's ranks (sharded parameters are gathered)."""
    from ..weights import from_flax, to_flax

    tree = to_flax(model)
    mesh = model.mesh if axis_size(model.mesh, model.sp_axis) > 1 else None
    plain = TransformerLM(
        vocab=model.vocab, dim=model.dim, heads=model.heads,
        layers=model.layers, mlp_ratio=model.mlp_ratio,
        compute_dtype=model.compute_dtype,
        device=model.device if device is None else device, mesh=mesh,
        sp_axis=model.sp_axis, n_experts=model.n_experts,
        moe_top_k=model.moe_top_k, moe_capacity=model.moe_capacity,
        remat=model.remat, remat_policy=model.remat_policy)
    return from_flax(tree, plain).to(plain.device)
