"""Incremental (KV-cached) decoding for :class:`TransformerLM` (the port
of ``ddstore_tpu/models/decode.py:38-349``).

The prompt prefills in one full forward pass, which runs the
flash-attention kernel on the card and returns every layer's K/V heads to
seed the cache; then one cached step per new token. With
``prefill_mesh`` the prefill runs over the mesh's ``sp`` axis, each rank
its chunk of the prompt through ring attention; the cache is then
gathered and every rank decodes the same tokens. The step's attention
over the cache is plain PyTorch, as it was plain XLA in the reference
(``decode.py:122-127``); the layer math around it is the training
:class:`~ddstore_tpu_torch.models.transformer.Block`'s own.

Unlike the reference's immutable arrays, the cache is updated in place:
one slot per layer per step, with no copy of the cache.

MoE blocks decode with dropless per-token top-k routing (the reference's
``decode.py:133-153``): each token's k experts with the training gates,
no capacity. :func:`moe_decode` computes every expert on every token and
combines each token's k, as the reference does: one read of each
expert's weights. A gather of each token's k experts' weights computes
the same function but reads B x k of them; at batch 8, top-2, it took
2.6x as long on an H100 at 700 W (``PERF.md``). The prefill routes as
training does, with ``token_mask`` from ``prompt_lengths`` and the
capacity of the real token count (``:276-294``), so its routing does not
depend on the padding.

A placed model (tensor, expert or fully-sharded parameters) decodes
through :func:`~ddstore_tpu_torch.models.transformer.unshard`.
"""

from __future__ import annotations

import copy
import math
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_index, axis_size
from .moe import default_capacity, routing_over
from .transformer import TransformerLM, _layer_norm

__all__ = ["init_cache", "decode_step", "filter_logits", "generate",
           "moe_decode"]

Cache = Dict[str, torch.Tensor]

NEG_INF = float("-inf")


def _refuse_extended(model: TransformerLM) -> None:
    if getattr(model, "extended", False):
        raise ValueError("decode caches the GPT block's k and v: "
                         "DeepSeek-V3's block (latent attention and held "
                         "experts) is trained, not decoded, in the port")


def init_cache(model: TransformerLM, batch: int, max_len: int) -> Cache:
    """Zeroed K/V cache: ``{"k", "v"}`` of shape (layers, B, H, L, hd) in
    the model's compute dtype, on the model's device."""
    _refuse_extended(model)
    hd = model.dim // model.heads
    shape = (model.layers, batch, model.heads, max_len, hd)
    return {n: torch.zeros(shape, dtype=model.compute_dtype,
                           device=model.device) for n in ("k", "v")}


@torch.no_grad()
def decode_step(model: TransformerLM, cache: Cache, pos, tokens: torch.Tensor,
                *, slot: Optional[int] = None,
                live_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One step: ``tokens`` (B, 1) at position ``pos`` (an int, or a (B,)
    tensor of per-row positions) -> (logits (B, 1, V) f32, cache).

    ``slot`` is the cache slot written (default ``pos``, which must then
    be an int); ``live_mask`` (B, max_len) bool overrides the default
    "slots <= slot are attendable" rule (padded prompts keep their dead
    slots masked). The cache is written in place and returned.
    """
    dt = model.compute_dtype
    b = tokens.shape[0]
    hd = model.dim // model.heads
    max_len = cache["k"].shape[3]
    if slot is None:
        slot = pos
    slot = int(slot)
    if slot < 0 or slot >= max_len:
        raise ValueError(f"slot {slot} outside cache [0, {max_len})")
    scale = 1.0 / math.sqrt(hd)
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=tokens.device).broadcast_to((b,))
    x = model.embed(tokens, positions[:, None])
    if live_mask is None:
        live = (torch.arange(max_len, device=tokens.device)
                <= slot)[None, None, None, :]
    else:
        live = live_mask[:, None, None, :]
    _refuse_placed(model)
    for i, blk in enumerate(model.blocks):
        q, k, v = blk.qkv_heads(x)  # (B, H, 1, hd)
        cache["k"][i, :, :, slot] = k[:, :, 0]
        cache["v"][i, :, :, slot] = v[:, :, 0]
        # bf16 operands with f32 products and sums, as the reference's
        # preferred_element_type=f32 einsums.
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         cache["k"][i].float()) * scale
        a = torch.softmax(s.masked_fill(~live, NEG_INF), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", a.to(dt).float(),
                           cache["v"][i].float())
        x = blk.attend_out(x, out.to(dt))
        if blk.n_experts > 0:
            h = _layer_norm(blk.ln2, x).to(dt).reshape(b, model.dim)
            x = x + moe_decode(blk.moe, h).reshape(b, 1, model.dim)
        else:
            x = blk.mlp(x)[0]
    return model.lmhead(x), cache


def moe_decode(moe, h: torch.Tensor) -> torch.Tensor:
    """Dropless top-k MoE for the (B, d) tokens of a decode step, in the
    compute dtype: every expert on every token, then each token's k
    outputs gated as in training (the raw router probability at k = 1,
    renormalised over the k otherwise) and summed in f32
    (``decode.py:140-153``)."""
    dt = moe.compute_dtype
    b, d = h.shape
    probs = torch.softmax(h.float() @ moe.router.weight.float().t(), -1)
    topv, topi = torch.topk(probs, moe.top_k, dim=-1)          # (B, k)
    gates = topv if moe.top_k == 1 else topv / topv.sum(-1, keepdim=True)
    x = h.to(dt)[None].expand(moe.n_experts, b, d)              # (E, B, d)
    he = torch.relu(torch.bmm(x, moe.w1.to(dt)) + moe.b1[:, None].to(dt))
    oe = torch.bmm(he, moe.w2.to(dt)) + moe.b2[:, None].to(dt)
    oe = oe.transpose(0, 1).gather(                               # (B,k,d)
        1, topi[..., None].expand(b, moe.top_k, d))
    return (oe.float() * gates[..., None]).sum(1).to(dt)


def _refuse_placed(model: TransformerLM) -> None:
    _refuse_extended(model)
    if any(hasattr(p, "placements") for p in model.parameters()):
        raise ValueError("decode runs on whole parameters; pass "
                         "transformer.unshard(model) for a placed model")


def filter_logits(lg: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Top-k / nucleus filtering of (B, V) logits (f32): tokens outside
    the kept set go to -inf. The highest-probability token always
    survives; both filters may be combined (the masks intersect)."""
    lg = lg.float()
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, NEG_INF)
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_p is not None and top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        # exclusive mass before each token: the first token whose
        # preceding mass reaches p is the first dropped
        cum = torch.cumsum(probs, dim=-1) - probs
        thresh = torch.where(cum < top_p, sorted_lg,
                             torch.full_like(sorted_lg, math.inf)
                             ).amin(dim=-1, keepdim=True)
        lg = lg.masked_fill(lg < thresh, NEG_INF)
    return lg


@torch.no_grad()
def generate(model: TransformerLM, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             prompt_lengths=None, stats: Optional[dict] = None,
             prefill_mesh=None) -> torch.Tensor:
    """Autoregressive continuation of ``prompt`` (B, P) int ->
    (B, P + max_new_tokens).

    ``temperature == 0`` is greedy; otherwise samples from
    ``softmax(logits / temperature)`` with ``generator``, after
    :func:`filter_logits`. With right-padded prompts, ``prompt_lengths``
    (B,) gives each row's real length: padding slots stay masked, row b's
    new token j sits at position ``len_b + j``, and all rows' new tokens
    land in columns ``[P, P + max_new_tokens)``.

    ``stats``, when given, receives ``prefill_s`` and ``decode_s`` (host
    seconds, the card synchronized at each boundary), ``decode_steps``
    and ``first_logits``, the (B, vocab) f32 logits of the first new
    token.

    **Long prompts** (``decode.py:227-230``): with ``prefill_mesh`` every
    rank of the mesh's ``sp`` axis (the model's ``sp_axis``) prefills its
    chunk of the prompt, ``[i * P/sp, (i + 1) * P/sp)``, through ring
    attention; the layers' K/V chunks are ``all_gather``ed over the axis
    into the full cache, the features of each row's last real position
    reach every rank (one all-reduce over the axis: the rank holding a
    position contributes it, the others zeros), and the decode loop runs
    the same on every rank. Every rank passes the whole prompt, and all
    of them call this together. ``P`` must divide by ``sp`` into chunks
    that are multiples of 8 (``ValueError`` otherwise). An MoE model's
    layers route the chunks over the axis in the whole prompt's token
    order, so the prefill routes as the mesh-free one does.
    """
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs `generator`")
    if max_new_tokens <= 0:
        return prompt
    b, plen = prompt.shape
    if plen < 1:
        raise ValueError("prompt must hold at least one token (the first "
                         "new token is conditioned on it)")
    dev = prompt.device
    total = plen + max_new_tokens
    lengths = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, dtype=torch.long)
        if tuple(lengths.shape) != (b,):
            raise ValueError(f"prompt_lengths shape {tuple(lengths.shape)} "
                             f"!= ({b},)")
        if (lengths < 1).any() or (lengths > plen).any():
            raise ValueError(f"prompt_lengths must be in [1, {plen}], got "
                             f"{lengths.tolist()}")
        lengths = lengths.to(dev)

    def pick(lg):
        lg = filter_logits(lg, top_k, top_p)
        if temperature > 0:
            p = torch.softmax(lg / temperature, dim=-1)
            nxt = torch.multinomial(p, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt.to(prompt.dtype)

    def sync():
        if stats is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _refuse_placed(model)
    sp = axis_size(prefill_mesh, model.sp_axis)
    if sp > 1 and (plen % sp or (plen // sp) % 8):
        raise ValueError(f"ring prefill of {plen} prompt tokens over sp={sp}"
                         f" needs chunks that are multiples of 8")

    moe = {}
    if lengths is not None and model.n_experts > 0:
        # pads take no capacity, and the capacity is the real tokens'
        moe["token_mask"] = torch.arange(plen, device=dev)[None, :] \
            < lengths[:, None]
        if model.moe_capacity is None:
            moe["moe_capacity"] = default_capacity(
                int(lengths.sum()), model.n_experts, model.moe_top_k)

    sync()
    t0 = time.perf_counter()
    cache = init_cache(model, b, total)
    if sp > 1:
        last = _ring_prefill(model, prompt, cache, prefill_mesh, sp,
                             lengths, moe)
    else:
        positions = torch.arange(plen, dtype=torch.int32,
                                 device=dev).expand(b, plen)
        feats, kvs = model(prompt, positions, return_features=True,
                           return_kv=True, **moe)
        for i, (k, v) in enumerate(kvs):
            cache["k"][i, :, :, :plen] = k
            cache["v"][i, :, :, :plen] = v
        # feats are already post-lnf: apply only the head (a second
        # LayerNorm is the documented trap). Padded rows condition on
        # their last real position.
        last = feats[:, -1] if lengths is None else \
            feats[torch.arange(b, device=dev), lengths - 1]
    toks = torch.zeros((b, total), dtype=prompt.dtype, device=dev)
    toks[:, :plen] = prompt
    first_logits = last.float() @ model.lmhead.head.weight.float().t()
    toks[:, plen] = pick(first_logits)
    sync()
    t1 = time.perf_counter()
    col = torch.arange(total, device=dev)
    prompt_live = None if lengths is None else \
        col[None, :] < lengths[:, None]
    for s in range(plen, total - 1):
        cur = toks[:, s:s + 1]
        if lengths is None:
            logits, cache = decode_step(model, cache, s, cur)
        else:
            live = prompt_live | ((col[None, :] >= plen)
                                  & (col[None, :] <= s))
            logits, cache = decode_step(model, cache, lengths + (s - plen),
                                        cur, slot=s, live_mask=live)
        toks[:, s + 1] = pick(logits[:, 0])
    sync()
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     decode_steps=max_new_tokens - 1,
                     first_logits=first_logits)
    return toks


def _ring_prefill(model: TransformerLM, prompt: torch.Tensor, cache: Cache,
                  mesh, sp: int, lengths, moe: dict) -> torch.Tensor:
    """This rank's chunk of the prompt through the ring; fills ``cache``
    with the gathered K/V of the whole prompt and returns the (B, dim)
    features of each row's last real position. MoE layers route the
    prompt's chunks over the axis in the order of the whole prompt
    (``moe`` holds the token mask and capacity of the whole prompt)."""
    b, plen = prompt.shape
    dev = prompt.device
    group = mesh.get_group(model.sp_axis)
    j, c = axis_index(mesh, model.sp_axis), plen // sp
    positions = torch.arange(j * c, (j + 1) * c, dtype=torch.int32,
                             device=dev).expand(b, c)
    ring = copy.copy(model)  # shares the parameters; the ring's mesh
    ring.mesh = mesh
    if "token_mask" in moe:
        moe = dict(moe, token_mask=moe["token_mask"][:, j * c:(j + 1) * c])
    with routing_over(model.modules(), group, (0, j, sp)):
        feats, kvs = ring(prompt[:, j * c:(j + 1) * c].contiguous(),
                          positions, return_features=True, return_kv=True,
                          **moe)
    # every layer's K and V in one gather: (layers, 2, B, H, c, hd)
    local = torch.stack([torch.stack(kv) for kv in kvs])
    staged = local.is_cuda and str(dist.get_backend(group)).lower() == "gloo"
    if staged:  # through host memory, as the ring's shifts over gloo
        local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(sp)]
    dist.all_gather(parts, local, group=group)
    full = torch.cat(parts, dim=4).to(dev)
    cache["k"][:, :, :, :plen] = full[:, 0]
    cache["v"][:, :, :, :plen] = full[:, 1]
    want = torch.full((b,), plen - 1, device=dev) if lengths is None \
        else lengths - 1
    mine = (want >= j * c) & (want < (j + 1) * c)
    rows = (want - j * c).clamp(0, c - 1)
    last = feats[torch.arange(b, device=dev), rows].float()
    last = torch.where(mine[:, None], last, torch.zeros_like(last))
    dist.all_reduce(last, group=group)
    return last
