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

**Latent attention and held experts** (DeepSeek-V3's block, off by
default, so the parity tests against the JAX package see the block
above): ``deepseek`` (:class:`DeepSeekSpec`) makes every norm an f32
RMSNorm of eps ``norm_eps`` and the embedding a plain lookup; attention
multi-head latent attention (:class:`MlaSpec`): q = W_q h as ``heads x
(nope + rope)``, ``[c, k_r] = W_kva h`` with c ``kv_rank`` wide and
RMSNormed, ``[k_nope, v] = W_kvb c``, the one k_r shared by every head,
the pairs (2i, 2i+1) of the rotary features of q and k_r rotated by ``pos
* rope_theta^(-2i/D)``, and causal softmax over ``(nope + rope)``-wide
scores through ``flash_attention``, whose values are ``v_dim`` wide; the
MLP of the first ``dense_layers`` layers ``down(silu(gate h) * up h)``,
``dense_hidden`` wide, and of the rest a :class:`~ddstore_tpu_torch.
models.moe.RoutedExperts` (this rank's held experts and the shared ones,
``routed``), whose balance losses :func:`lm_loss` adds and whose
selection biases :func:`make_train_step` moves after each update. Only
training on one rank takes it: decode, any mesh, and pipeline stages
raise ``ValueError``.

``n_experts > 0`` swaps each block's MLP for a top-k
:class:`~ddstore_tpu_torch.models.moe.MoeMlp`, and :func:`lm_loss` adds
``MOE_AUX_WEIGHT`` times the layers' mean aux. :func:`create_train_state`
over a mesh with ``tp``, ``ep`` or ``fsdp`` axes places the parameters by
the reference's rules (``parallel.tp``, ``parallel.fsdp``): tensor and
expert shards as DTensors, ZeRO-3 through FSDP2. The layers compute on
their local shards and take their collectives from their parameters'
placements; the head, vocab-sharded under tp, gets a vocab-parallel
cross-entropy.

Pipeline parallelism (the reference's ``transformer.py:425-826``):
:func:`create_pp_train_state` cuts the model into stages
(:func:`lm_to_stages`; this rank keeps its :class:`PipelineStage`: the
embedding on the first stage, the head on the last, its chunks of
blocks), and :func:`make_pp_train_step` runs the GPipe, 1F1B or
interleaved schedules of :mod:`~ddstore_tpu_torch.parallel.pipeline` over
the mesh's ``pp`` axis, composed with dp, and with tp, sp and ep inside
each stage. :func:`lm_from_stages` reassembles the whole model on rank 0.
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
from ..parallel.mesh import axes_group, axis_index, axis_size
from ..parallel.ring_attention import ring_attention
from ..utils.profile import annotate
from .moe import (MoeMlp, RoutedExperts, RoutedSpec, _axis_of, _local,
                  init_expert_)

__all__ = ["MlaSpec", "DeepSeekSpec", "Block", "EmbedPE", "LMHead", "TransformerLM", "loss_fn",
           "lm_loss", "MOE_AUX_WEIGHT", "moe_aux_sum", "TrainState",
           "create_train_state", "make_train_step", "REMAT_POLICIES",
           "param_digest", "broadcast_parameters", "all_reduce_gradients",
           "unshard", "head_nll", "StageChunk", "PipelineStage",
           "lm_to_stages", "lm_from_stages", "create_pp_train_state",
           "pp_gpipe_value_and_grad", "pp_1f1b_value_and_grad",
           "make_pp_train_step", "pp_batch_rows", "PP_SCHEDULES",
           "route_layout"]

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MlaSpec:
    """Multi-head latent attention (DeepSeek-V2 section 2.1) without query
    compression: keys and values from a ``kv_rank``-wide latent; each
    head's query and key ``qk_nope`` features without position and
    ``qk_rope`` rotary ones (the rotary key one vector shared by the
    heads); values ``v_dim`` wide."""

    kv_rank: int
    qk_nope: int
    qk_rope: int
    v_dim: int


@dataclasses.dataclass(frozen=True)
class DeepSeekSpec:
    """DeepSeek-V3's block (the module docstring): latent attention
    ``mla`` with rope of ``rope_theta``, RMSNorms of eps ``norm_eps``, a
    SwiGLU MLP ``dense_hidden`` wide in the first ``dense_layers`` layers
    and the held-expert layer ``routed`` in the rest."""

    mla: MlaSpec
    routed: RoutedSpec
    dense_hidden: int
    dense_layers: int
    norm_eps: float
    rope_theta: float


def _norm_module(dim: int, device, rms_eps: Optional[float] = None
                 ) -> nn.Module:
    """flax's LayerNorm (the GPT block), or an RMSNorm of eps ``rms_eps``
    (DeepSeek-V3's)."""
    if rms_eps is None:
        return nn.LayerNorm(dim, eps=LN_EPS, device=device)
    return nn.RMSNorm(dim, eps=rms_eps, device=device)


def _layer_norm(ln: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The norm ``ln`` (LayerNorm or RMSNorm) of ``x``, in f32."""
    if isinstance(ln, nn.RMSNorm):
        return F.rms_norm(x.float(), ln.normalized_shape, ln.weight, ln.eps)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def rope_table(positions: torch.Tensor, d: int, theta: float
               ) -> torch.Tensor:
    """The rotations of a D-wide rotary embedding at ``positions`` (B,
    S): complex64 (B, S, D/2), entry i ``exp(1j * pos * theta^(-2i/D))``.
    Made once a forward and shared by the layers."""
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=positions.device) / d)
    ang = positions.float()[..., None] * inv
    return torch.polar(torch.ones_like(ang), ang)


def rope(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of ``x`` (B, S, ..., D) by ``table``
    (:func:`rope_table`, (B, S', D/2) with S' >= S): each pair (2i, 2i+1)
    of features, taken as one complex number, times its rotation, in f32,
    returned in x's dtype."""
    b, s = x.shape[0], x.shape[1]
    t = table[:, :s].reshape(b, s, *([1] * (x.dim() - 3)), -1)
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * t).flatten(-2).to(x.dtype)


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
                 moe_capacity: Optional[int] = None, *,
                 deepseek: Optional[DeepSeekSpec] = None,
                 held_experts: bool = False):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.compute_dtype = compute_dtype
        self.n_experts = n_experts
        # DeepSeek-V3's block: latent attention, and held experts in
        # place of its dense SwiGLU where ``held_experts``
        self.mla = None if deepseek is None else deepseek.mla
        self.routed = deepseek.routed if held_experts else None
        self.swiglu = deepseek is not None and not held_experts
        eps = None if deepseek is None else deepseek.norm_eps
        self.ln1 = _norm_module(dim, device, eps)
        mla = self.mla
        if mla is None:
            self.qkv = nn.Linear(dim, 3 * dim, bias=False, device=device)
            self.proj = nn.Linear(dim, dim, bias=False, device=device)
        else:
            qk = mla.qk_nope + mla.qk_rope
            self.q = nn.Linear(dim, heads * qk, bias=False, device=device)
            self.kv_a = nn.Linear(dim, mla.kv_rank + mla.qk_rope,
                                  bias=False, device=device)
            self.kv_norm = _norm_module(mla.kv_rank, device, eps)
            self.kv_b = nn.Linear(mla.kv_rank,
                                  heads * (mla.qk_nope + mla.v_dim),
                                  bias=False, device=device)
            self.proj = nn.Linear(heads * mla.v_dim, dim, bias=False,
                                  device=device)
        self.ln2 = _norm_module(dim, device, eps)
        if self.routed is not None:
            self.moe = RoutedExperts(dim, self.routed, compute_dtype,
                                     device=device)
        elif n_experts > 0:
            self.moe = MoeMlp(dim, n_experts, mlp_ratio * dim,
                              top_k=moe_top_k, capacity=moe_capacity,
                              compute_dtype=compute_dtype, device=device)
        elif self.swiglu:
            hidden = deepseek.dense_hidden
            self.gate_up = nn.Linear(dim, 2 * hidden, bias=False,
                                     device=device)
            self.down = nn.Linear(hidden, dim, bias=False, device=device)
        else:
            self.up = nn.Linear(dim, mlp_ratio * dim, device=device)
            self.down = nn.Linear(mlp_ratio * dim, dim, device=device)

    def qkv_heads(self, x: torch.Tensor,
                  rotary: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
        """(B, S, dim) -> q, k, v as (B, H, S, hd) views of one
        projection (the kernel reads them in place by stride); ``H`` is
        this rank's heads under tensor parallelism. Under ``mla`` they are
        the latent attention's (B, H, S, nope + rope), rotated by
        ``rotary`` (:func:`rope_table` of the positions), and v (B, H, S,
        v_dim)."""
        b, s, _ = x.shape
        dt = self.compute_dtype
        h = _layer_norm(self.ln1, x).to(dt)
        if self.mla is not None:
            return self._mla_heads(h, rotary)
        qkv = _dense(self.qkv, h, dt)
        hd = self.dim // self.heads
        width = qkv.shape[-1] // 3
        return tuple(t.reshape(b, s, width // hd, hd).transpose(1, 2)
                     for t in qkv.split(width, dim=-1))

    def _mla_heads(self, h: torch.Tensor, rotary: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
        """Latent attention's q, k (the shared rotary key broadcast to
        every head) and v from the normed input ``h``."""
        b, s, _ = h.shape
        dt, m, nh = self.compute_dtype, self.mla, self.heads
        q = _dense(self.q, h, dt).view(b, s, nh, m.qk_nope + m.qk_rope)
        c, k_r = _dense(self.kv_a, h, dt).split([m.kv_rank, m.qk_rope], -1)
        kv = _dense(self.kv_b, _layer_norm(self.kv_norm, c).to(dt), dt)
        k_nope, v = kv.view(b, s, nh, m.qk_nope + m.v_dim).split(
            [m.qk_nope, m.v_dim], -1)
        q_nope, q_r = q.split([m.qk_nope, m.qk_rope], -1)
        # one rotation of q's rotary heads and the shared key together
        q_r, k_r = rope(torch.cat([q_r, k_r[:, :, None, :]], dim=2),
                        rotary).split([nh, 1], dim=2)
        q = torch.cat([q_nope, q_r], dim=-1)
        k = torch.cat([k_nope, k_r.expand(b, s, nh, m.qk_rope)], dim=-1)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

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
        if self.routed is not None:
            y, aux = self.moe(h.reshape(b * s, self.dim), rows=b)
            return x + y.reshape(b, s, self.dim).to(dt), aux
        if self.n_experts > 0:
            y, aux = self.moe(h.reshape(b * s, self.dim), valid,
                              moe_capacity, rows=b)
            return x + y.reshape(b, s, self.dim).to(dt), aux
        if self.swiglu:
            g, u = _dense(self.gate_up, h, dt).chunk(2, dim=-1)
            return x + _row_dense(self.down, F.silu(g) * u, dt), None
        h = F.gelu(_dense(self.up, h, dt), approximate="tanh")
        return x + _row_dense(self.down, h, dt), None

    def forward(self, x: torch.Tensor, mesh=None, sp_axis: str = "sp",
                valid: Optional[torch.Tensor] = None,
                moe_capacity: Optional[int] = None,
                rotary: Optional[torch.Tensor] = None
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
        kernel needs. ``rotary`` is the rotary embedding's
        :func:`rope_table`, at least as long as the padded sequence."""
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
                                     else x, rotary)
            with annotate("ddstore:attention"):
                out, _ = flash_attention(q, k, v, causal=True)
            if pad:
                out, k, v = out[:, :, :s], k[:, :, :s], v[:, :, :s]
        x, aux = self.mlp(self.attend_out(x, out), valid, moe_capacity)
        return x, (k, v), aux


class EmbedPE(nn.Module):
    """Token embedding + fixed sinusoidal positions (global positions, so
    any context length works)."""

    def __init__(self, vocab: int, dim: int, compute_dtype: torch.dtype,
                 device=None, sinusoids: bool = True):
        super().__init__()
        self.dim = dim
        self.compute_dtype = compute_dtype
        self.sinusoids = sinusoids
        self.tok = nn.Embedding(vocab, dim, device=device)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.embedding(tokens.long(), self.tok.weight).to(dt)
        if not self.sinusoids:
            return x
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

    def __init__(self, vocab: int, dim: int, device=None,
                 rms_eps: Optional[float] = None):
        super().__init__()
        self.lnf = _norm_module(dim, device, rms_eps)
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

# The data axes of a step: their ranks hold different tokens (those of
# tp and ep hold the same).
DATA_AXES = ("dp", "sp", "fsdp")


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


def _block_out(blk: "Block", x, mesh, sp_axis, valid, moe_capacity,
               rotary=None):
    x, _, aux = blk(x, mesh, sp_axis, valid, moe_capacity, rotary)
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
    after each forward ``moe_aux`` holds the layers' aux losses. Over a
    mesh, :func:`create_train_state` makes the layers route over the data
    ranks (dp, fsdp and sp) in the global token order.

    ``deepseek`` builds DeepSeek-V3's block (the module docstring); it
    excludes ``n_experts``.
    """

    def __init__(self, vocab: int = 1024, dim: int = 256, heads: int = 8,
                 layers: int = 4, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None, mesh=None, sp_axis: str = "sp",
                 n_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity: Optional[int] = None, remat: bool = False,
                 remat_policy: Optional[str] = None, *,
                 deepseek: Optional[DeepSeekSpec] = None):
        super().__init__()
        if deepseek is not None and n_experts:
            raise ValueError("deepseek (held experts) and n_experts (the "
                             "capacity MoE) exclude each other")
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
        self.deepseek = deepseek
        self.extended = deepseek is not None
        self.routed = None if deepseek is None else deepseek.routed
        refuse_extended(self, mesh, "TransformerLM")
        self.embed = EmbedPE(vocab, dim, compute_dtype, device=device,
                             sinusoids=deepseek is None)
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_ratio, compute_dtype, device=device,
                  n_experts=n_experts, moe_top_k=moe_top_k,
                  moe_capacity=moe_capacity, deepseek=deepseek,
                  held_experts=deepseek is not None
                  and i >= deepseek.dense_layers)
            for i in range(layers))
        self.lmhead = LMHead(vocab, dim, device=device,
                             rms_eps=None if deepseek is None
                             else deepseek.norm_eps)

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
        if return_kv and self.extended:
            raise ValueError("return_kv seeds the decode cache, which "
                             "DeepSeek-V3's block (latent attention and "
                             "held experts) does not reach: only training "
                             "takes it")
        remat = self.remat and torch.is_grad_enabled() and not return_kv
        ctx_fn = _remat_context_fn(self.remat_policy) if remat else None
        valid = None if token_mask is None else token_mask.reshape(-1)
        x = self.embed(tokens, positions)
        rotary = None
        if self.deepseek is not None:
            # padded as the blocks pad the sequence for the kernels
            pad = -positions.shape[1] % 8
            rotary = rope_table(F.pad(positions, (0, pad)),
                                self.deepseek.mla.qk_rope,
                                self.deepseek.rope_theta)
        kvs: List[KV] = []
        aux: List[torch.Tensor] = []
        for blk in self.blocks:
            if remat:
                kw = {} if ctx_fn is None else {"context_fn": ctx_fn}
                out = checkpoint(_block_out, blk, x, self.mesh,
                                 self.sp_axis, valid, moe_capacity,
                                 rotary, use_reentrant=False, **kw)
                x, a = out if isinstance(out, tuple) else (out, None)
            else:
                x, kv, a = blk(x, self.mesh, self.sp_axis, valid,
                               moe_capacity, rotary)
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
        return head_nll(self.lmhead, x, targets, fused, xent_block,
                        self.compute_dtype)


def head_nll(lmhead: LMHead, x: torch.Tensor, targets: torch.Tensor,
             fused: bool, xent_block: int, compute_dtype: torch.dtype
             ) -> torch.Tensor:
    """Each token's f32 negative log-likelihood under ``lmhead`` from the
    last block's output ``x``: through the fused cross-entropy when
    ``fused``, the vocab-parallel one when the head is split over tensor
    ranks."""
    feats = lmhead(x, features_only=True)
    w = lmhead.head.weight
    group, idx = _axis_of(w, 0)
    if group is not None:
        if fused:
            raise ValueError("the fused cross-entropy needs the whole "
                             "vocab head; a tensor-parallel head is "
                             "vocab-sharded (pass fused_xent=False)")
        return _vocab_parallel_nll(feats, _local(w), targets, group, idx)
    if not fused:
        logp = torch.log_softmax(F.linear(feats, w.float()), dim=-1)
        return -logp.gather(-1, targets.long()[..., None])[..., 0]
    nll = fused_linear_xent(
        feats.reshape(-1, feats.shape[-1]).to(compute_dtype),
        w.t(), targets.reshape(-1), xent_block, compute_dtype)
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
    elif model.routed is not None:
        # each held-expert layer's balance loss, already weighted by alpha
        loss = loss + moe_aux_sum(model)
    return loss


def refuse_extended(model: nn.Module, mesh, what: str) -> None:
    """``ValueError`` where a model of DeepSeek-V3's block (the module
    docstring) meets a mesh: it trains on one rank only (the held experts'
    selection bias and load are this rank's alone)."""
    if getattr(model, "extended", False) and mesh is not None:
        raise ValueError(
            f"{what}: DeepSeek-V3's block (latent attention and held "
            f"experts) trains on one rank only, without a mesh")


@torch.no_grad()
def update_routing_bias(model: nn.Module) -> None:
    """Every held-expert layer's loss-free balancing update
    (:meth:`~ddstore_tpu_torch.models.moe.RoutedExperts.update_bias`)."""
    for m in model.modules():
        if isinstance(m, RoutedExperts):
            m.update_bias()


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
    both are present; over fsdp x sp the step sums the sharded gradients
    over sp too. The MoE layers route over the mesh's data axes (dp, fsdp
    and sp) in the global token order (:func:`~ddstore_tpu_torch.models.
    moe.route`). The optimizer is made on the placed parameters, so its
    moments are sharded alike."""
    refuse_extended(model, mesh, "create_train_state")
    if mesh is not None:
        _check_replicas(model)
        if isinstance(model, TransformerLM):
            _place_lm(model, mesh)
        elif axis_size(mesh, "fsdp") > 1:
            raise ValueError("this model family places itself over fsdp: "
                             "use its own create_train_state")
    opt = adam(model.parameters(), lr)
    return TrainState(model, opt, mesh=mesh), opt


def route_layout(mesh, row_axes: Tuple[str, ...], sp_axis: str = "sp"):
    """(group, place) of MoE routing over ``mesh``: the ranks that differ
    along ``row_axes`` (which split the batch's rows, in that order) and
    ``sp_axis`` (which splits each row's sequence), and this rank's
    ``(block, chunk, chunks)`` among them (``moe.route``)."""
    block = 0
    for a in row_axes:
        block = block * axis_size(mesh, a) + axis_index(mesh, a)
    place = (block, axis_index(mesh, sp_axis), axis_size(mesh, sp_axis))
    return axes_group(mesh, tuple(row_axes) + (sp_axis,)), place


def _place_lm(model: TransformerLM, mesh) -> None:
    from ..parallel.fsdp import place_zero3
    from ..parallel.tp import shard_pytree

    if model.n_experts > 0:
        if model.n_experts % axis_size(mesh, "ep"):
            raise ValueError(f"{model.n_experts} experts do not split over "
                             f"ep={axis_size(mesh, 'ep')}")
        group, place = route_layout(mesh, ("dp", "fsdp"), model.sp_axis)
        for blk in model.blocks:
            blk.moe.route_group, blk.moe.route_place = group, place
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
    it: FSDP2's reduce-scatter for the fully-sharded ones (then, over sp,
    one all-reduce of their shards), and one
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

    Under a profiler the step opens the ``ddstore:`` ranges that
    ``utils/profile.py`` lists (zero_grad, forward, backward, allreduce,
    optimizer); with none active it opens nothing.
    """
    if mesh is None:
        mesh = model.mesh if state is None or state.mesh is None \
            else state.mesh
    if mesh is not model.mesh and axis_size(mesh, model.sp_axis) > 1:
        raise ValueError(
            f"make_train_step's mesh splits the sequence over "
            f"{model.sp_axis!r}, but the model's ring runs over "
            f"model.mesh ({model.mesh!r}); build the model with this mesh")
    refuse_extended(model, mesh, "make_train_step")
    if axis_size(mesh, "pp") > 1:
        raise ValueError("mesh has a pp axis: the pipelined step is "
                         "make_pp_train_step, over the stages "
                         "create_pp_train_state splits the model into")
    if mesh is not None:
        if any(axis_size(mesh, a) > 1 for a in ("tp", "ep", "fsdp")) and \
                (state is None or state.mesh is not mesh):
            raise ValueError("mesh has tp/ep/fsdp axes: pass the `state` "
                             "create_train_state placed over this mesh, "
                             "so the step keeps its parameters sharded")
    world = dist.get_world_size() if mesh is not None else 1
    routed = getattr(model, "routed", None) is not None
    params = list(model.parameters())
    reduced = [p for p in params if not _fsdp_managed(p)]
    data = axes_group(mesh, DATA_AXES)
    n_data = 1 if data is None else dist.get_world_size(data)
    # FSDP2 reduces over its own mesh (fsdp, and dp when hybrid): the sp
    # ranks hold other tokens of the same rows, so their sharded
    # gradients are summed over sp too, and FSDP2's mean over its ranks
    # becomes the mean over all the data ranks
    sharded = [p for p in params if _fsdp_managed(p)]
    sp_group = axes_group(mesh, (model.sp_axis,)) if sharded else None

    def forward_backward(tok, tgt, pos) -> torch.Tensor:
        with annotate("ddstore:forward"):
            loss = lm_loss(model, tok, tgt, pos, fused_xent=fused_xent)
        with annotate("ddstore:backward"):
            loss.backward()
        return loss.detach()

    def step(tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
        with annotate("ddstore:zero_grad"):
            opt.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = forward_backward(tokens, targets, positions)
        else:
            if tokens.shape[0] % accum_steps:
                raise ValueError(f"batch {tokens.shape[0]} not divisible "
                                 f"by accum_steps {accum_steps}")
            # The f32 parameters' .grad sums the chunks' gradients.
            loss = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            for chunk in zip(*(t.chunk(accum_steps) for t in
                               (tokens, targets, positions))):
                loss = loss + forward_backward(*chunk)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(accum_steps)
            loss = loss / accum_steps
        if mesh is not None:
            with annotate("ddstore:allreduce"):
                if data is not None:
                    all_reduce_gradients(reduced, n_data, data)
                if sp_group is not None:
                    all_reduce_gradients(
                        sharded, dist.get_world_size(sp_group), sp_group)
                loss = loss.float().clone()
                dist.all_reduce(loss)
                loss = loss / world
        with annotate("ddstore:optimizer"):
            opt.step()
            if routed:
                update_routing_bias(model)
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

    if model.extended:
        raise ValueError("unshard goes through the JAX package's layout, "
                         "which has no latent attention or held experts")
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


# ---------------------------------------------------------------------------
# Pipeline parallelism: the LM cut into stages (the reference's
# transformer.py:425-826). The blocks run through the schedules of
# parallel/pipeline.py, a rank holding its stage's chunks; the embedding
# lives on the first stage and the head on the last (the reference
# replicates both over pp: ROADMAP C).
# ---------------------------------------------------------------------------


def _stage_group_size(layers: int, n_stages: int) -> int:
    """Layers per stage (ceil: trailing stages pad), the one size rule of
    ``lm_to_stages``, ``lm_from_stages`` and the stage body. Refuses a
    layout where a whole stage would be padding."""
    g = -(-layers // n_stages)
    if layers <= (n_stages - 1) * g:
        raise ValueError(
            f"{n_stages} stages of {g} layers leave at least one stage "
            f"with zero real layers (layers={layers}); use fewer stages")
    return g


class StageChunk(nn.Module):
    """One chunk of the model: ``g`` consecutive blocks (``layers``),
    the trailing ones zero-parameter pads where the depth does not divide.
    The ``_valid`` buffer marks the real ones (the reference's float
    ``_valid`` leaf); a pad is never run, so it stays an identity with no
    gradient, and Adam moves none of its weights."""

    def __init__(self, layers: List[Block], valid: List[bool]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.register_buffer("_valid", torch.tensor(valid, dtype=torch.bool,
                                                    device=layers[0].qkv
                                                    .weight.device))
        self.valid = [bool(v) for v in valid]


class PipelineStage(nn.Module):
    """This rank's part of a :class:`TransformerLM` cut into pipeline
    stages: the embedding on the first stage, the head on the last, and
    the stage's ``n_virtual`` chunks (``chunks[v]`` is model chunk ``v·S +
    stage``). It keeps the model's configuration; the schedules of
    :func:`make_pp_train_step` run it."""

    def __init__(self, model: TransformerLM, stage: int, n_stages: int,
                 n_virtual: int, chunks: List[StageChunk]):
        super().__init__()
        for k in ("vocab", "dim", "heads", "layers", "mlp_ratio",
                  "compute_dtype", "sp_axis", "n_experts", "moe_top_k",
                  "moe_capacity"):
            setattr(self, k, getattr(model, k))
        self.stage, self.n_stages, self.n_virtual = stage, n_stages, \
            n_virtual
        self.group_size = _stage_group_size(model.layers,
                                            n_stages * n_virtual)
        self.embed = model.embed if stage == 0 else None
        self.chunks = nn.ModuleList(chunks)
        self.lmhead = model.lmhead if stage == n_stages - 1 else None

    @property
    def device(self) -> torch.device:
        return self.chunks[0].layers[0].ln1.weight.device


def lm_to_stages(model: TransformerLM, n_stages: int, n_virtual: int = 1,
                 stage: int = 0) -> PipelineStage:
    """Stage ``stage`` of ``model`` cut into ``n_stages * n_virtual``
    contiguous chunks of ``ceil(layers / chunks)`` blocks (the reference's
    ``lm_to_stages``, ``transformer.py:452-496``, for one stage): its
    chunks are model chunks ``v·S + stage``, the device-major order of
    ``interleave_order``. The model's modules move into the stage (no
    copy); trailing pads are zero-parameter blocks. Uneven depths pad the
    trailing chunks; a chunk of pads alone raises ``ValueError``."""
    from ..parallel.pipeline import interleave_order

    if getattr(model, "extended", False):
        raise ValueError("pipeline stages take the GPT block only: "
                         "DeepSeek-V3's block trains on one rank")
    n_chunks = n_stages * n_virtual
    g = _stage_group_size(model.layers, n_chunks)
    order = interleave_order(n_stages, n_virtual)
    chunks = []
    for pos in range(stage * n_virtual, (stage + 1) * n_virtual):
        layers, valid = [], []
        for j in range(g):
            li = order[pos] * g + j
            if li < model.layers:
                layers.append(model.blocks[li])
            else:
                pad = Block(model.dim, model.heads, model.mlp_ratio,
                            model.compute_dtype, device=model.device,
                            n_experts=model.n_experts,
                            moe_top_k=model.moe_top_k,
                            moe_capacity=model.moe_capacity)
                with torch.no_grad():
                    for p in pad.parameters():
                        p.zero_()
                layers.append(pad)
            valid.append(li < model.layers)
        chunks.append(StageChunk(layers, valid))
    return PipelineStage(model, stage, n_stages, n_virtual, chunks)


def lm_from_stages(stage: PipelineStage, mesh=None, pp_axis: str = "pp",
                   device=None) -> Optional[TransformerLM]:
    """The whole model, reassembled from every stage, on global rank 0
    (None on the others); pads dropped (the reference's
    ``lm_from_stages``, ``:499-513``). A collective of the mesh's ranks:
    tensor and expert shards are gathered whole, and each stage's rank at
    position 0 of every other axis sends its stage to rank 0. The model
    is mesh-free, on ``device`` (default the stage's)."""
    from ..parallel.mesh import stage_ring
    from ..weights import from_flax, stage_tree, tree_from_stages

    piece = stage_tree(stage)
    ring = stage_ring(mesh, pp_axis)
    others = [a for a in (mesh.mesh_dim_names if mesh is not None else ())
              if a != pp_axis]
    root = all(axis_index(mesh, a) == 0 for a in others)
    pieces = [piece]
    if ring.size > 1 and root:
        pieces = [None] * ring.size if ring.index == 0 else None
        dist.gather_object(piece, pieces, dst=dist.get_global_rank(
            ring.group, 0), group=ring.group)
    if not (root and ring.index == 0):
        return None
    from ..weights import join_stage_trees

    outer, stages = join_stage_trees(pieces, stage.layers, stage.n_stages,
                                     stage.n_virtual)
    flat = tree_from_stages(outer, stages, stage.layers, stage.n_stages,
                            stage.n_virtual)
    model = TransformerLM(
        vocab=stage.vocab, dim=stage.dim, heads=stage.heads,
        layers=stage.layers, mlp_ratio=stage.mlp_ratio,
        compute_dtype=stage.compute_dtype,
        device=stage.device if device is None else device,
        n_experts=stage.n_experts, moe_top_k=stage.moe_top_k,
        moe_capacity=stage.moe_capacity)
    return from_flax(flat, model)


def _head_xent(stage: PipelineStage, lmhead: LMHead, y, targets,
               fused: bool, xent_block: int = 8192) -> torch.Tensor:
    """The head and the token-mean cross-entropy of post-block
    activations, the one head of every schedule (fused as ``lm_loss``
    fuses it; vocab-parallel under tensor parallelism)."""
    return head_nll(lmhead, y, targets, fused, xent_block,
                    stage.compute_dtype).mean()


def _make_stage_fn(model, n_chunks: int, with_aux: bool = False, mesh=None):
    """The stage body of the schedules: ``(chunk, x) -> x``, or ``(x,
    side)`` with ``with_aux``, ``side`` the chunk's real layers' MoE aux
    summed and divided by ``layers`` (so the sum over chunks is the
    sequential step's layer mean). A pad layer is skipped. With a mesh
    whose sp axis is larger than 1 the blocks ring their attention over
    it (pp x sp)."""
    _stage_group_size(model.layers, n_chunks)
    sp_mesh = mesh if axis_size(mesh, model.sp_axis) > 1 else None

    def stage_fn(chunk: StageChunk, x):
        side = None
        for blk, real in zip(chunk.layers, chunk.valid):
            if not real:
                continue
            x, _, a = blk(x, sp_mesh, model.sp_axis)
            if with_aux:
                side = a if side is None else side + a
        if with_aux:
            return x, side / model.layers
        return x

    return stage_fn


def pp_batch_rows(batch: int, n_microbatches: int, dp: int, j: int
                  ) -> List[int]:
    """The global rows of a ``batch``-row step that dp rank ``j`` holds
    under the reference's placement (``transformer.py:624-628`` and
    ``pipeline.py:129``): microbatch ``i`` is rows ``[i·mb, (i + 1)·mb)``
    and its dp shard ``j`` rows ``[i·mb + j·mb/dp, i·mb + (j + 1)·mb/dp)``.
    A pp step takes these rows, in this order, as rank ``j``'s batch."""
    mb = batch // n_microbatches
    sub = mb // dp
    return [i * mb + j * sub + r for i in range(n_microbatches)
            for r in range(sub)]


def _microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """(B, ...) -> (M, B // M, ...): contiguous slices of the batch."""
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch of {b} rows does not split into "
                         f"{n_microbatches} microbatches")
    return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])


def _pp_finish(stage: PipelineStage, st, mesh, dp_axis, head_sum, side_sum,
               aux_weight, m):
    """The step's loss, replicated on every rank: the head's microbatch
    mean plus the side losses over the pp ring, averaged over the data
    ranks (dp x fsdp x sp; fsdp ranks are replicas that hold their dp
    slot's rows); and each parameter's gradient averaged over them."""
    loss = torch.zeros((), dtype=torch.float32, device=side_sum.device)
    if st.d == st.s - 1:
        loss = loss + head_sum / m
    loss = loss + aux_weight * side_sum / m
    if st.ring is not None and st.ring.group is not None:
        dist.all_reduce(loss, group=st.ring.group)
    data = axes_group(mesh, tuple(a for a in (dp_axis, "fsdp",
                                              stage.sp_axis)
                                  if a is not None))
    if data is not None:
        n = dist.get_world_size(data)
        all_reduce_gradients(list(stage.parameters()), n, data)
        dist.all_reduce(loss, group=data)
        loss = loss / n
    return loss.detach()


def _pp_prologue(stage, tokens, targets, positions, m):
    """The embedding on the first stage (its graph kept for the inputs'
    gradient), the targets by microbatch, and the activation's shape."""
    b, s_local = tokens.shape
    mb = _microbatch(tokens, m).shape[1]
    x = stage.embed(tokens, positions) if stage.embed is not None else None
    xm = None if x is None else _microbatch(x, m)
    like = torch.empty((mb, s_local, stage.dim), dtype=stage.compute_dtype,
                       device=tokens.device)
    return x, xm, _microbatch(targets, m), like


def pp_gpipe_value_and_grad(stage: PipelineStage, stage_fn, tokens, targets,
                            positions, *,
                            n_microbatches: int, mesh=None,
                            pp_axis: str = "pp",
                            dp_axis: Optional[str] = None,
                            remat: bool = False, with_aux: bool = False,
                            aux_weight: float = 0.0,
                            fused_xent: bool = False,
                            xent_block: int = 8192,
                            n_virtual: int = 1) -> torch.Tensor:
    """The loss, and every stage parameter's gradient in ``.grad``,
    through the GPipe schedule (the interleaved one at ``n_virtual > 1``):
    the production path of ``make_pp_train_step(schedule="gpipe")``. A
    collective of the mesh's ranks, each passing its dp slot's rows
    (:func:`pp_batch_rows`) and its sequence chunk.

    ``stage`` is this rank's :class:`PipelineStage` (the reference's
    ``(outer, stages)`` state, this rank's part of it). The first stage
    embeds and feeds the microbatches; the last runs the head
    on each microbatch's output as it comes out of the forward ticks, and
    its cotangent starts that microbatch's backward. Gradients are
    averaged over the data ranks; the loss is returned on every rank."""
    from ..parallel.pipeline import GPipe, _Stage

    m = n_microbatches
    st = _Stage(mesh, pp_axis, n_virtual, m)
    x, xm, tm, like = _pp_prologue(stage, tokens, targets, positions, m)
    head_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    dys = {}

    def on_final(i, y):
        nonlocal head_sum
        yl = y.detach().requires_grad_()
        with torch.enable_grad():
            loss = _head_xent(stage, stage.lmhead, yl, tm[i], fused_xent,
                              xent_block)
            (loss / m).backward()
        head_sum = head_sum + loss.detach().float()
        dys[i] = yl.grad

    eng = GPipe(st, stage_fn, list(stage.chunks), lambda i: xm[i], like,
                with_aux=with_aux, remat=remat)
    side = eng.forward(on_final)
    dx = eng.backward(lambda i: dys.pop(i), aux_weight / m)
    if x is not None:
        x.backward(torch.stack([dx[i] for i in range(m)]).view_as(x))
    return _pp_finish(stage, st, mesh, dp_axis, head_sum, side, aux_weight,
                      m)


def pp_1f1b_value_and_grad(stage: PipelineStage, stage_fn, tokens, targets,
                           positions, *,
                           n_microbatches: int, mesh=None,
                           pp_axis: str = "pp",
                           dp_axis: Optional[str] = None,
                           with_aux: bool = False, aux_weight: float = 0.0,
                           fused_xent: bool = False, xent_block: int = 8192,
                           n_virtual: int = 1) -> torch.Tensor:
    """As :func:`pp_gpipe_value_and_grad` through the fused 1F1B schedule
    (interleaved at ``n_virtual > 1``): the head runs on the last stage
    in the tick its microbatch's output is made, and that microbatch's
    backward starts there; at most ``2·V·S - 1`` stage graphs are live on
    a rank."""
    from ..parallel.pipeline import _Stage, run_1f1b

    m = n_microbatches
    st = _Stage(mesh, pp_axis, n_virtual, m)
    x, xm, tm, like = _pp_prologue(stage, tokens, targets, positions, m)
    head_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def head(i, y):
        nonlocal head_sum
        yl = y.detach().requires_grad_()
        with torch.enable_grad():
            loss = _head_xent(stage, stage.lmhead, yl, tm[i], fused_xent,
                              xent_block)
            (loss / m).backward()
        head_sum = head_sum + loss.detach().float()
        return yl.grad

    side, dx = run_1f1b(st, stage_fn, list(stage.chunks), lambda i: xm[i],
                        like, head, with_aux=with_aux,
                        side_cot=aux_weight / m)
    if x is not None:
        x.backward(torch.stack([dx[i] for i in range(m)]).view_as(x))
    return _pp_finish(stage, st, mesh, dp_axis, head_sum, side, aux_weight,
                      m)


def _pp_rules(mesh, pp_axis, tp_axis, ep_axis):
    """The placement of a stage's parameters (``create_pp_train_state``,
    ``transformer.py:604-611``): its chunks by ``pp_stage_rules`` read
    for one stage, the embedding and head by Megatron's rules over tp;
    None when nothing is sharded."""
    from ..parallel.tp import megatron_rules, pp_stage_rules, \
        stage_local_rules

    tp = tp_axis if axis_size(mesh, tp_axis) > 1 else None
    ep = ep_axis if axis_size(mesh, ep_axis) > 1 else None
    if tp is None and ep is None:
        return None
    inner = stage_local_rules(pp_stage_rules(pp_axis, tp, ep))
    outer = megatron_rules(tp) if tp else (lambda path, leaf: ())

    def rules(path, leaf):
        return inner(path, leaf) if path[0] == "chunks" else \
            outer(path, leaf)

    return rules


def create_pp_train_state(model: TransformerLM, n_stages: int,
                          lr: float = 3e-4, mesh=None, pp_axis: str = "pp",
                          tp_axis: str = "tp", ep_axis: str = "ep",
                          n_virtual: int = 1
                          ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """This rank's stage of ``model`` (:func:`lm_to_stages` at its
    position along ``pp_axis``) and Adam over it, as the reference's
    ``create_pp_train_state`` (``transformer.py:583-621``) returns its
    ``(outer, stages)`` state. Every rank holds the same full weights
    (checked as ``create_train_state`` checks them); the model's modules
    move into the stage. ``n_virtual > 1`` cuts ``V·S`` chunks for the
    interleaved schedules.

    On a mesh whose ``tp_axis`` is larger than 1 the chunks carry
    Megatron's placement (``parallel.tp.pp_stage_rules``, q, k and v by
    heads) and the head is vocab-sharded; a larger ``ep_axis`` shards the
    experts. An MoE layer routes each microbatch's dp shard alone, as the
    reference's stages do (over sp, the shard's rows in the global order of
    their chunks). Over an ``fsdp`` axis the stages are replicas, as the
    reference leaves them (it places tp and ep only over a pp mesh, and
    its data ``P(dp, sp)``): an fsdp rank takes its dp slot's rows, and
    :func:`make_pp_train_step` averages the gradients over dp x fsdp x sp."""
    s = axis_size(mesh, pp_axis)
    if mesh is None and n_stages != 1:
        raise ValueError(f"{n_stages} stages need a mesh with a "
                         f"{pp_axis!r} axis of that size")
    if mesh is not None and s != n_stages:
        raise ValueError(f"n_stages={n_stages} but the mesh's {pp_axis!r} "
                         f"axis has size {s}")
    if mesh is not None:
        _check_replicas(model)
        if model.heads % axis_size(mesh, tp_axis):
            raise ValueError(f"{model.heads} heads do not split over "
                             f"{tp_axis}={axis_size(mesh, tp_axis)}")
        if model.n_experts % axis_size(mesh, ep_axis):
            raise ValueError(f"{model.n_experts} experts do not split over "
                             f"{ep_axis}={axis_size(mesh, ep_axis)}")
    stage = lm_to_stages(model, n_stages, n_virtual,
                         axis_index(mesh, pp_axis))
    # a stage routes one microbatch's dp shard: its rows, whole over sp
    group, place = route_layout(mesh, (), model.sp_axis)
    for chunk in stage.chunks:
        for blk in chunk.layers:
            if blk.n_experts > 0:
                blk.moe.route_group, blk.moe.route_place = group, place
    rules = _pp_rules(mesh, pp_axis, tp_axis, ep_axis)
    if rules is not None:
        from ..parallel.tp import shard_pytree
        shard_pytree(stage, mesh, rules)
    opt = adam(stage.parameters(), lr)
    return TrainState(stage, opt, mesh=mesh), opt


PP_SCHEDULES = ("gpipe", "1f1b", "interleaved", "interleaved_1f1b")


def make_pp_train_step(model: PipelineStage, opt: torch.optim.Optimizer,
                       mesh, n_stages: int, n_microbatches: int,
                       pp_axis: str = "pp", dp_axis: str = "dp",
                       tp_axis: str = "tp", remat: bool = False,
                       schedule: str = "gpipe",
                       fused_xent: Optional[bool] = None,
                       xent_block: int = 8192, n_virtual: int = 1,
                       state: Optional[TrainState] = None
                       ) -> Callable[[torch.Tensor, torch.Tensor,
                                      torch.Tensor], torch.Tensor]:
    """The dp x pp train step over ``(tokens, targets, positions)``: this
    rank's stage (``model``, from :func:`create_pp_train_state`) runs the
    ``schedule``, then one ``opt`` update. Each rank passes its dp slot's
    rows in :func:`pp_batch_rows`' order (the ranks of one slot pass the
    same rows; the first stage reads the tokens, the last the targets)
    and, over sp, its sequence chunk; the local batch splits into
    ``n_microbatches``. Returns the loss (f32, every rank the same).

    * ``"gpipe"``: :func:`pp_gpipe_value_and_grad`; every microbatch's
      stage graph is live until the backward, unless ``remat``.
    * ``"1f1b"``: :func:`pp_1f1b_value_and_grad`, at most ``2S - 1``
      live.
    * ``"interleaved"`` / ``"interleaved_1f1b"``: the same with
      ``n_virtual`` chunks a stage (the state must be cut with the same
      ``n_virtual``; ``n_microbatches`` a multiple of the stages).

    MoE models add ``MOE_AUX_WEIGHT`` times the microbatch mean of their
    layers' mean aux, each microbatch's dp shard routed alone (capacity
    clips microbatch-sized token sets, as the reference's stages do).
    ``fused_xent`` None fuses the head at ``vocab >= 2 * xent_block``
    unless the mesh has a tp axis (``transformer.py:773-780``)."""
    if schedule not in PP_SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule!r}")
    if not schedule.startswith("interleaved") and n_virtual != 1:
        raise ValueError(
            f"n_virtual={n_virtual} only applies to the interleaved "
            f"schedules, got {schedule!r}")
    if model.n_stages != n_stages or model.n_virtual != n_virtual:
        raise ValueError(
            f"the stage was cut for {model.n_stages} stages x "
            f"{model.n_virtual} chunks, the step asks for {n_stages} x "
            f"{n_virtual}: build the state with the same n_virtual")
    if axis_size(mesh, pp_axis) != n_stages:
        raise ValueError(f"n_stages={n_stages} but the mesh's {pp_axis!r} "
                         f"axis has size {axis_size(mesh, pp_axis)}")
    if fused_xent is None:
        fused_xent = model.vocab >= 2 * xent_block \
            and not axis_size(mesh, tp_axis) > 1
    moe = model.n_experts > 0
    aux_weight = MOE_AUX_WEIGHT if moe else 0.0
    stage_fn = _make_stage_fn(model, n_stages * n_virtual, with_aux=moe,
                              mesh=mesh)
    dp = dp_axis if axis_size(mesh, dp_axis) > 1 else None
    kw = dict(n_microbatches=n_microbatches, mesh=mesh, pp_axis=pp_axis,
              dp_axis=dp, with_aux=moe, aux_weight=aux_weight,
              fused_xent=fused_xent, xent_block=xent_block,
              n_virtual=n_virtual)
    if schedule.endswith("1f1b"):
        grads_of = functools.partial(pp_1f1b_value_and_grad, **kw)
    else:
        grads_of = functools.partial(pp_gpipe_value_and_grad, remat=remat,
                                     **kw)

    def step(tokens: torch.Tensor, targets: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = grads_of(model, stage_fn, tokens, targets, positions)
        opt.step()
        if state is not None:
            state.step += 1
        return loss

    return step
