"""Incremental (KV-cached) decoding for :class:`TransformerLM` (the port
of ``ddstore_tpu/models/decode.py:38-349``, dense models).

The prompt prefills in one full forward pass, which runs the
flash-attention kernel on the card and returns every layer's K/V heads to
seed the cache; then one cached step per new token. The step's attention
over the cache is plain PyTorch, as it was plain XLA in the reference
(``decode.py:122-127``); the layer math around it is the training
:class:`~ddstore_tpu_torch.models.transformer.Block`'s own.

Unlike the reference's immutable arrays, the cache is updated in place:
one slot per layer per step, with no copy of the cache.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

import torch

from .transformer import TransformerLM

__all__ = ["init_cache", "decode_step", "filter_logits", "generate"]

Cache = Dict[str, torch.Tensor]

NEG_INF = float("-inf")


def init_cache(model: TransformerLM, batch: int, max_len: int) -> Cache:
    """Zeroed K/V cache: ``{"k", "v"}`` of shape (layers, B, H, L, hd) in
    the model's compute dtype, on the model's device."""
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
        x = blk.finish(x, out.to(dt))
    return model.lmhead(x), cache


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
             prompt_lengths=None, stats: Optional[dict] = None
             ) -> torch.Tensor:
    """Autoregressive continuation of ``prompt`` (B, P) int ->
    (B, P + max_new_tokens).

    ``temperature == 0`` is greedy; otherwise samples from
    ``softmax(logits / temperature)`` with ``generator``, after
    :func:`filter_logits`. With right-padded prompts, ``prompt_lengths``
    (B,) gives each row's real length: padding slots stay masked, row b's
    new token j sits at position ``len_b + j``, and all rows' new tokens
    land in columns ``[P, P + max_new_tokens)``.

    ``stats``, when given, receives ``prefill_s`` and ``decode_s`` (host
    seconds, the card synchronized at each boundary) and ``decode_steps``.
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

    sync()
    t0 = time.perf_counter()
    cache = init_cache(model, b, total)
    positions = torch.arange(plen, dtype=torch.int32,
                             device=dev).expand(b, plen)
    feats, kvs = model(prompt, positions, return_features=True,
                       return_kv=True)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :, :plen] = k
        cache["v"][i, :, :, :plen] = v
    # feats are already post-lnf: apply only the head (a second LayerNorm
    # is the documented trap). Padded rows condition on their last real
    # position.
    last = feats[:, -1] if lengths is None else \
        feats[torch.arange(b, device=dev), lengths - 1]
    toks = torch.zeros((b, total), dtype=prompt.dtype, device=dev)
    toks[:, :plen] = prompt
    toks[:, plen] = pick(last.float() @ model.lmhead.head.weight.float().t())
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
                     decode_steps=max_new_tokens - 1)
    return toks
