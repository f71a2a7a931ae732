"""Mixture-of-experts MLP with top-k routing and expert parallelism (the
port of ``ddstore_tpu/models/moe.py``).

:class:`MoeMlp` keeps every semantic of the reference:

* the router is an f32 ``Linear`` (no bias) on f32 input; softmax, top-k;
* ``top_k=1`` keeps the raw router probability as the gate (Switch),
  ``top_k>1`` renormalises over the chosen k (GShard);
* capacity claims are choice-major: every token's first choice is placed
  before any token's second choice, so overflow drops second choices
  first; assignments past an expert's capacity are dropped;
* ``capacity`` overrides the ``cf * k * T / E`` rule of
  :func:`default_capacity` (``capacity >= T`` is dropless);
* tokens with ``valid=False`` take no capacity, get a zero output row and
  drop out of the aux statistics;
* the experts are ReLU FFNs computed in ``compute_dtype``; dispatch and
  combine are f32;
* aux = ``E * sum_e frac_e * mean_prob_e`` (1 at uniform routing).

The reference dispatches with a one-hot ``(k, T, E, C)`` tensor and
einsums; here the same function is computed by index, with nothing larger
than ``(k, T, E)`` integers: each kept assignment's slot is its expert's
running count in choice-major order (:func:`route`), one ``index_put``
fills the ``(E, C, d)`` buffer, ``torch.bmm`` runs the experts, and one
gather reads each assignment's output for the f32 gated sum. Dropped
assignments write to, and read from, one spare row past the buffer.

**Routing over a data group.** The reference sees the step's global token
set: it flattens the ``(B, S)`` batch row-major and takes every choice's
capacity claims in that order. Here each rank holds a block of rows and,
over ``sp``, one chunk of each of them. With ``route_group`` (the ranks
that hold different tokens: the mesh's ``dp``, ``fsdp`` and ``sp`` axes)
and ``route_place`` (this rank's block of rows, its chunk, and the number
of chunks a row is cut into) the capacity is that of the global token
count, and one ``all_gather`` a layer of the ``(k, rows, E)`` counts gives
each assignment its slot in the global choice-major ``(k, b*S + s)``
order: every assignment of earlier choices, then in its choice those of
every earlier row (all of its chunks), then those of earlier chunks of its
row, then its position in its own chunk. Each rank runs its own kept
assignments through the experts (the FFN is row-wise, so no token moves).
``frac`` and ``mean_prob`` are global: the aux this rank returns is ``D``
times its share (``D`` the group's size), whose mean over the group is the
global aux and whose gradient, averaged over the group as the train step
averages gradients, is the global aux's.

**Expert parallelism.** When ``w1`` is a DTensor sharded over an ``ep``
axis (``parallel.tp.expert_rules``), this rank holds ``E/ep`` experts; the
ranks along ``ep`` hold the same tokens, route them alike, each runs its
own experts, and one sum over ``ep`` of the per-assignment outputs
completes the combine (the reference's contraction over the sharded
expert dim). Under ``ep x tp`` the experts' hidden dim is split over
``tp`` as a Megatron pair, with a sum over ``tp`` after ``w2``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (all_gather_counts, copy_to_group,
                                    group_size, reduce_from_group)

__all__ = ["default_capacity", "Routing", "route", "MoeMlp", "routing_over"]


def default_capacity(tokens: int, n_experts: int, top_k: int,
                     capacity_factor: float = 2.0) -> int:
    """The per-expert buffer size: ``cf * k * T / E`` slots, at least 1,
    at most ``T`` (``moe.py:43-50``)."""
    return min(tokens, max(1, int(capacity_factor * top_k * tokens
                                  / n_experts)))


class Routing(NamedTuple):
    """The routing of a layer's tokens. Per-assignment fields are
    choice-major ``(k, T)``: row ``c`` holds every token's ``c``-th
    choice."""

    probs: torch.Tensor       # (T, E) f32 router probabilities
    expert: torch.Tensor      # (k, T) int64 chosen expert
    gate: torch.Tensor        # (k, T) f32 gate
    slot: torch.Tensor        # (k, T) int64 slot in the global order
    local_slot: torch.Tensor  # (k, T) int64 slot among this rank's
    kept: torch.Tensor        # (k, T) bool: valid and within capacity
    counts: torch.Tensor      # (k, E) int64 assignments of the group
    nvalid: torch.Tensor      # () int64 valid tokens of the group
    capacity: int


def route(logits: torch.Tensor, top_k: int, capacity: int,
          valid: Optional[torch.Tensor] = None, group=None, rows: int = 1,
          place: Optional[Tuple[int, int, int]] = None) -> Routing:
    """Top-k routing of ``logits`` (T, E), this rank's ``rows`` rows of
    ``T / rows`` tokens, with choice-major capacity claims over the tokens
    of every rank of ``group`` in the global row-major order.

    ``place`` is ``(block, chunk, chunks)``: this rank holds rows ``[block
    * rows, (block + 1) * rows)`` of the global batch, and chunk ``chunk``
    of the ``chunks`` a row is cut into along the sequence. Every rank of
    the group passes its own, and they cover the batch. None is ``(group
    rank, 0, 1)``: whole rows, blocks in rank order."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)
    gates = topv if top_k == 1 else topv / topv.sum(-1, keepdim=True)
    expert = topi.t()                                     # (k, T)
    v = torch.ones(t, dtype=torch.bool, device=logits.device) \
        if valid is None else valid.to(torch.bool)
    oh = F.one_hot(expert, e) * v[None, :, None]          # (k, T, E)
    per_row = oh.view(top_k, rows, t // rows, e)
    row_counts = per_row.sum(2)                           # (k, R, E)
    counts = row_counts.sum(1)                            # (k, E)
    d = group_size(group)
    block, chunk, chunks = place if place is not None else \
        (dist.get_rank(group) if d > 1 else 0, 0, 1)
    mine = torch.cat([row_counts.reshape(-1), v.sum().reshape(1),
                      torch.tensor([block * chunks + chunk],
                                   device=logits.device)])
    every = all_gather_counts(mine, group)                # (D, k*R*E + 2)
    # every rank's row counts in the global order of (row, chunk)
    order = torch.argsort(every[:, -1])
    g = every[order, :-2].view(d // chunks, chunks, top_k, rows, e)
    g = g.permute(2, 0, 3, 1, 4).reshape(top_k, -1, e)    # (k, N, E)
    tot_c = g.sum(1)
    # the slot of this rank's first assignment to x in (choice c, local
    # row r): every earlier choice's assignments to x, then those of
    # every earlier (row, chunk) of choice c
    mine_at = torch.arange(rows, device=logits.device) * chunks \
        + (block * rows * chunks + chunk)
    off = (torch.cumsum(tot_c, 0) - tot_c)[:, None, :] \
        + (torch.cumsum(g, 1) - g)[:, mine_at, :]         # (k, R, E)
    ex = expert.view(top_k, rows, t // rows)
    pos = torch.cumsum(per_row, 2).gather(3, ex[..., None])[..., 0] - 1
    slot = (off.gather(2, ex) + pos).view(top_k, t)
    lpos = torch.cumsum(oh, 1).gather(2, expert[..., None])[..., 0] - 1
    local_slot = (torch.cumsum(counts, 0) - counts).gather(1, expert) + lpos
    kept = v[None, :] & (slot < capacity)
    return Routing(probs, expert, gates.t(), slot, local_slot, kept, tot_c,
                   every[:, -2].sum(), capacity)


class MoeMlp(nn.Module):
    """Drop-in MLP replacement: ``forward((T, d)) -> ((T, d), aux)``.

    Parameters (the reference's names and shapes): ``router`` (a Linear
    ``d -> E`` without bias), ``w1 (E, d, h)``, ``b1 (E, h)``, ``w2 (E, h,
    d)``, ``b2 (E, d)``. ``route_group`` is the data group routing runs
    over and ``route_place`` this rank's ``(block, chunk, chunks)`` in it
    (:func:`route`; both set from the mesh by ``transformer.
    create_train_state`` or :func:`routing_over`; None routes this rank's
    tokens alone). After each forward, ``stats`` holds the group's
    assignments per expert (``routed``, (E,)), the kept ones and the aux,
    detached."""

    def __init__(self, dim: int, n_experts: int, hidden: int,
                 capacity_factor: float = 2.0, top_k: int = 1,
                 capacity: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k={top_k} must be in [1, n_experts="
                             f"{n_experts}]")
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.n_experts, self.hidden, self.top_k = n_experts, hidden, top_k
        self.capacity_factor, self.capacity = capacity_factor, capacity
        self.compute_dtype = compute_dtype
        self.route_group = None
        self.route_place: Optional[Tuple[int, int, int]] = None
        self.stats: dict = {}
        self.router = nn.Linear(dim, n_experts, bias=False, device=device)
        e, h = n_experts, hidden
        self.w1 = nn.Parameter(torch.empty(e, dim, h, device=device))
        self.b1 = nn.Parameter(torch.zeros(e, h, device=device))
        self.w2 = nn.Parameter(torch.empty(e, h, dim, device=device))
        self.b2 = nn.Parameter(torch.zeros(e, dim, device=device))

    def capacity_for(self, tokens: int) -> int:
        """The per-expert capacity for ``tokens`` tokens of the group."""
        if self.capacity is not None:
            return min(tokens, self.capacity)
        return default_capacity(tokens, self.n_experts, self.top_k,
                                self.capacity_factor)

    def routing(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                capacity: Optional[int] = None, rows: int = 1) -> Routing:
        """The routing of ``x`` (T, d), ``rows`` rows of this rank's
        tokens, over ``route_group``; ``capacity`` overrides the layer's
        own for this call."""
        t = x.shape[0] * group_size(self.route_group)
        cap = self.capacity_for(t) if capacity is None else min(t, capacity)
        logits = F.linear(x.float(), _local(self.router.weight).float())
        return route(logits, self.top_k, cap, valid, self.route_group, rows,
                     self.route_place)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor] = None,
                capacity: Optional[int] = None, rows: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t, d = x.shape
        k, dt = self.top_k, self.compute_dtype
        r = self.routing(x, valid, capacity, rows)
        w1, b1, w2, b2 = (_local(p) for p in (self.w1, self.b1, self.w2,
                                                self.b2))
        ep_group, ep_rank = _axis_of(self.w1, 0)
        tp_group, _ = _axis_of(self.w1, 2)
        e_loc, cap = w1.shape[0], r.capacity
        e0 = ep_rank * e_loc
        # every assignment's row of the flat buffer: expert * C + slot for
        # the kept ones of this rank's experts, else the spare last row
        mine = r.kept & (r.expert >= e0) & (r.expert < e0 + e_loc)
        spare = e_loc * cap
        row = torch.where(mine, (r.expert - e0) * cap + r.local_slot,
                          torch.full_like(r.expert, spare)).reshape(-1)
        xe = x.to(dt)
        for g in (ep_group, tp_group):
            xe = copy_to_group(xe, g)
        buf = xe.new_zeros(spare + 1, d).index_put(
            (row,), xe.repeat(k, 1))
        h = torch.bmm(buf[:spare].view(e_loc, cap, d), w1.to(dt))
        h = torch.relu(h + b1[:, None, :].to(dt))
        out = torch.bmm(h, w2.to(dt))
        out = reduce_from_group(out.float(), tp_group).to(dt) \
            if group_size(tp_group) > 1 else out
        out = out + b2[:, None, :].to(dt)
        flat = torch.cat([out.reshape(spare, d),
                          out.new_zeros(1, d)]).float()
        o = reduce_from_group(flat[row], ep_group).view(k, t, d)
        y = (o * r.gate[..., None]).sum(0)

        v = torch.ones(t, dtype=torch.float32, device=x.device) \
            if valid is None else valid.to(torch.float32)
        nvalid = torch.clamp(r.nvalid.to(torch.float32), min=1.0)
        routed = r.counts.sum(0)
        frac = routed.to(torch.float32) / (nvalid * k)
        prob_sum = (r.probs * v[:, None]).sum(0)
        aux = self.n_experts * torch.sum(frac * prob_sum) / nvalid \
            * group_size(self.route_group)
        self.stats = {"routed": routed.detach(),
                      "kept": torch.clamp(routed, max=cap).detach(),
                      "aux": aux.detach()}
        return y.to(x.dtype), aux


@contextlib.contextmanager
def routing_over(layers, group, place: Tuple[int, int, int]):
    """Route every MoE layer of ``layers`` over ``group`` from ``place``
    while the block runs (the ring prefill's sequence chunks), restoring
    each layer's own routing after."""
    moes = [m for m in layers if isinstance(m, MoeMlp)]
    saved = [(m.route_group, m.route_place) for m in moes]
    for m in moes:
        m.route_group, m.route_place = group, place
    try:
        yield
    finally:
        for m, (g, p) in zip(moes, saved):
            m.route_group, m.route_place = g, p


def _local(p: torch.Tensor) -> torch.Tensor:
    """A parameter's local tensor (its shard, for a DTensor)."""
    return p.to_local() if hasattr(p, "to_local") else p


def _axis_of(p: torch.Tensor, dim: int):
    """(group, index) of the model axis (not a data axis: FSDP's shards
    are whole while a layer computes) that shards ``p``'s dim ``dim``;
    (None, 0) when none does."""
    if not hasattr(p, "placements"):
        return None, 0
    mesh = p.device_mesh
    for i, pl in enumerate(p.placements):
        # Shard(d) and _StridedShard(d, ...) (the per-head qkv) both
        # carry the sharded dim
        if getattr(pl, "dim", None) == dim and \
                mesh.mesh_dim_names[i] not in ("dp", "fsdp"):
            return mesh.get_group(i), mesh.get_local_rank(i)
    return None, 0


def init_expert_(p: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal`` scale for an ``(E, in, out)`` expert weight:
    the expert dim counts as receptive field, so fan-in is ``E * in``."""
    r = torch.randn(p.shape, generator=generator, device=generator.device)
    p.copy_(r / math.sqrt(p.shape[0] * p.shape[1]))
