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

**Held experts (DeepSeek-V3's layer).** :class:`RoutedExperts` is the
layer of one rank of expert parallelism told which experts it holds
(``RoutedSpec.held``), with no mesh: it routes every token over all the
layer's experts and computes only its own experts' part of the result,
dropless. The router's logits are f32; each expert's score is their
sigmoid; the top k of score plus a bias (``score_bias``, a buffer moved by
DeepSeek-V3's loss-free balancing rule in :meth:`RoutedExperts.
update_bias`, not by gradients) are chosen, and each chosen expert's gate
is ``scale * s_i / sum of the chosen s``, from the scores without the
bias. The held assignments are sorted by expert and run as one grouped
product a projection (``torch._grouped_mm`` on the card, one product a
held expert elsewhere) inside :class:`_HeldExperts`, whose backward is
the port's own and runs the products again rather than keep the
assignments' features; gates are applied and summed in f32 by one
``index_add`` over the held assignments. Shared experts, which every
token goes through, are one SwiGLU ``shared * hidden`` wide. The layer's
aux is DeepSeek-V3's sequence-wise balance loss (eqs. 17-20), weighted by
``RoutedSpec.balance``. What the experts this rank does not hold would
add is left out.

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
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import (all_gather_counts, copy_to_group,
                                    group_size, reduce_from_group)
from ..ops import held
from ..utils.profile import annotate

__all__ = ["default_capacity", "Routing", "route", "MoeMlp", "routing_over",
           "RoutedSpec", "RoutedExperts", "held_counters"]


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


@dataclasses.dataclass(frozen=True)
class RoutedSpec:
    """A DeepSeek-V3 expert layer (:class:`RoutedExperts`): ``experts``
    routed experts of ``hidden`` features each (SwiGLU), ``top_k`` chosen
    a token, this rank holding ``held = (first, count)`` of them (None:
    all); ``shared`` shared experts; gates scaled by ``scale`` (the
    source's ``routed_scaling_factor``); the selection bias moved by
    ``bias_rate`` (gamma) a step; the balance loss weighted by
    ``balance`` (alpha)."""

    experts: int
    top_k: int
    hidden: int
    held: Optional[Tuple[int, int]] = None
    shared: int = 0
    scale: float = 1.0
    bias_rate: float = 0.0
    balance: float = 0.0

    @property
    def first(self) -> int:
        return 0 if self.held is None else self.held[0]

    @property
    def count(self) -> int:
        return self.experts if self.held is None else self.held[1]


#: what the held-expert layers ran in this process, as :func:`held_counters`
#: reads it: forwards (a plain count), and by device a tensor of the held
#: assignments and of the most tokens one held expert took in one forward
#: since the last reset, summed there so that no forward waits on the host
_HELD = {"forwards": 0}
_HELD_ON: Dict[torch.device, torch.Tensor] = {}


def _count_held(sizes: torch.Tensor) -> None:
    """Adds a forward's held tokens an expert (``sizes``, on the device)."""
    _HELD["forwards"] += 1
    acc = _HELD_ON.get(sizes.device)
    if acc is None:
        acc = _HELD_ON[sizes.device] = torch.zeros(
            2, dtype=torch.int64, device=sizes.device)
    acc[0] += sizes.sum()
    torch.maximum(acc[1], sizes.max(), out=acc[1])


def held_counters(reset: bool = False) -> dict:
    """The held-expert counters (``forwards``, ``assignments``,
    ``max_per_expert``) as plain integers; reading them waits for the
    device. ``reset`` zeroes ``max_per_expert`` after the copy."""
    accs = [a.tolist() for a in _HELD_ON.values()]
    out = {"forwards": _HELD["forwards"],
           "assignments": sum(a[0] for a in accs),
           "max_per_expert": max((a[1] for a in accs), default=0)}
    if reset:
        for a in _HELD_ON.values():
            a[1] = 0
    return out


def _grouped(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
             ) -> torch.Tensor:
    """``a`` (N, K) in groups ending at ``offs``, each times its own
    ``w[g]`` (G, K, M): (N, M) in a's dtype, f32 sums; rows past
    ``offs[-1]`` unwritten. One ``torch._grouped_mm`` on the card (bf16),
    one product a group on the CPU."""
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=offs)
    out = a.new_empty(a.shape[0], w.shape[2])
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        out[lo:hi] = a[lo:hi] @ w[g]
        lo = hi
    return out


def _grouped_wgrad(a: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor
                   ) -> torch.Tensor:
    """Each group's ``a_g^T dy_g``: (G, K, M) from ``a`` (N, K) and ``dy``
    (N, M) in groups ending at ``offs``; 0 for a group of none."""
    if a.is_cuda:
        out = torch._grouped_mm(a.t(), dy, offs=offs)
        empty = torch.diff(offs, prepend=offs.new_zeros(1)) == 0
        return out.masked_fill_(empty[:, None, None], 0)
    lo, out = 0, []
    for hi in offs.tolist():
        out.append(a[lo:hi].t() @ dy[lo:hi])
        lo = hi
    return torch.stack(out)


class _HeldExperts(torch.autograd.Function):
    """The held experts' part of the layer, from the layer's input ``x``
    (T, d) in the compute dtype to its f32 output (T, d), through buffers
    of ``rows`` rows (``ops/held.py``): each token's held choices
    (``pos`` (T, k), their rows in expert order, -1 for experts held
    elsewhere; ``offs`` each held expert's end) are scattered
    (``ddstore:dispatch``), run through their experts' SwiGLU as grouped
    products (``ddstore:experts``; ``w_in`` (E, d, 2h) holds each expert's
    gate and up columns, ``w_out`` (E, h, d), both f32 and rounded to x's
    dtype for the products), and summed into their tokens times their f32
    ``gates`` (T, k) (``ddstore:combine``). Nothing is read on the host.

    It saves x, the choices and the gates alone, nothing as large as the
    assignments' features, so that a step's memory does not grow with how
    many tokens the routing sends here; the backward
    (``ddstore:experts_bwd``) scatters and runs the products again, and
    sums each token's gradient from its held experts in f32."""

    @staticmethod
    def forward(ctx, x, pos, gates, w_in, w_out, offs, rows):
        with annotate("ddstore:dispatch"):
            xs = held.scatter_rows(x, pos, rows)
        with annotate("ddstore:experts"):
            _, ys = _held_swiglu(xs, w_in, w_out, offs)
        with annotate("ddstore:combine"):
            y = held.combine(ys, pos, gates, torch.float32)
        ctx.save_for_backward(x, pos, gates, w_in, w_out, offs)
        ctx.rows = rows
        return y

    @staticmethod
    def backward(ctx, dy):
        with annotate("ddstore:experts_bwd"):
            x, pos, gates, w_in, w_out, offs = ctx.saved_tensors
            xs = held.scatter_rows(x, pos, ctx.rows)
            (gu, act, wi, wo), ys = _held_swiglu(xs, w_in, w_out, offs)
            dys, dgates = held.combine_bwd(dy, ys, pos, gates)
            del ys
            dw_out = _grouped_wgrad(act, dys, offs)
            da = _grouped(dys, wo.transpose(1, 2), offs)
            del act, dys
            dgu = held.swiglu_bwd(gu, da, offs)
            del gu, da
            dxs = _grouped(dgu, wi.transpose(1, 2), offs)
            dw_in = _grouped_wgrad(xs, dgu, offs)
            del xs, dgu
            dx = held.combine(dxs, pos, None, x.dtype)
        return (dx, None, dgates, dw_in.float(), dw_out.float(), None,
                None)


def _held_swiglu(xs, w_in, w_out, offs):
    """((gate|up, silu(gate) * up, the weights in xs's dtype), the
    output) of the held experts' SwiGLU on ``xs`` sorted by expert."""
    dt = xs.dtype
    wi, wo = w_in.to(dt), w_out.to(dt)
    gu = _grouped(xs, wi, offs)
    act = held.swiglu_rows(gu, offs)
    return (gu, act, wi, wo), _grouped(act, wo, offs)


class RoutedExperts(nn.Module):
    """DeepSeek-V3's expert layer, this rank's share of it: ``forward((T,
    d), rows) -> ((T, d) f32, aux)`` (the module docstring's "Held
    experts"). Parameters: ``router`` (d -> experts, no bias), ``w_in``
    (held, d, 2 * hidden: gate then up), ``w_out`` (held, hidden, d), and
    with shared experts ``shared_gate_up`` (d -> 2 * shared * hidden) and
    ``shared_down``; the buffer ``score_bias`` (experts,). After each
    forward ``stats`` holds ``counts``, the assignments per expert over
    all the layer's experts (detached)."""

    def __init__(self, dim: int, spec: RoutedSpec,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        first, count = spec.first, spec.count
        if not 1 <= spec.top_k <= spec.experts or first < 0 or count < 1 \
                or first + count > spec.experts:
            raise ValueError(f"{spec}: top_k must lie in [1, experts] and "
                             f"the held experts among them")
        self.spec, self.compute_dtype = spec, compute_dtype
        h = spec.hidden
        self.router = nn.Linear(dim, spec.experts, bias=False, device=device)
        self.w_in = nn.Parameter(torch.empty(count, dim, 2 * h,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(count, h, dim, device=device))
        if spec.shared:
            self.shared_gate_up = nn.Linear(dim, 2 * spec.shared * h,
                                            bias=False, device=device)
            self.shared_down = nn.Linear(spec.shared * h, dim, bias=False,
                                         device=device)
        self.register_buffer("score_bias", torch.zeros(spec.experts,
                                                       device=device))
        self.register_buffer("load", torch.zeros(
            spec.experts, dtype=torch.int64, device=device),
            persistent=False)
        self.stats: dict = {}

    def route(self, x: torch.Tensor, rows: int):
        """(chosen experts (T, k), gates (T, k) f32, the balance loss) of
        ``x`` (T, d), ``rows`` rows of ``T / rows`` tokens."""
        sp = self.spec
        logits = F.linear(x.float(), self.router.weight.float())
        s = torch.sigmoid(logits)
        idx = torch.topk(s.detach() + self.score_bias, sp.top_k,
                         dim=-1).indices
        chosen = s.gather(1, idx)
        gates = sp.scale * chosen / chosen.sum(-1, keepdim=True)
        t, e = s.shape
        # DeepSeek-V3 eqs. 17-20 a row: f_i = E / (k T) * (times i was
        # chosen), P_i = the mean of s_i / sum_j s_j, alpha * sum_i f_i P_i
        # counted by a scatter, which does not wait on the host
        ones = torch.ones(idx.shape, device=x.device).view(rows, -1)
        hits = torch.zeros(rows, e, device=x.device).scatter_add_(
            1, idx.view(rows, -1), ones)
        f = hits * (e / (sp.top_k * (t // rows)))
        p = (s / s.sum(-1, keepdim=True)).view(rows, t // rows, e).mean(1)
        balance = sp.balance * (f * p).sum(-1).mean()
        return idx, gates, balance

    def forward(self, x: torch.Tensor, rows: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sp, dt = self.spec, self.compute_dtype
        t, d = x.shape
        first, count, k = sp.first, sp.count, sp.top_k
        with annotate("ddstore:router"):
            idx, gates, balance = self.route(x, rows)
            flat = idx.reshape(-1)
            counts = torch.zeros(sp.experts, dtype=torch.int64,
                                 device=x.device).scatter_add_(
                0, flat, torch.ones_like(flat))
            self.load += counts
        with annotate("ddstore:dispatch"):
            # the held choices' rows, in expert order, before the rest
            local = idx - first
            mine = (local >= 0) & (local < count)
            order = torch.argsort(
                torch.where(mine, local, count).reshape(-1), stable=True)
            row = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=x.device))
            pos = torch.where(mine, row.view(t, k), -1)
            sizes = counts[first:first + count]
            offs = sizes.cumsum(0).to(torch.int32)
        xd = x.to(dt)
        if sp.shared:
            with annotate("ddstore:shared_experts"):
                g, u = F.linear(xd, self.shared_gate_up.weight.to(dt)) \
                    .chunk(2, dim=-1)
                shared = F.linear(F.silu(g) * u,
                                  self.shared_down.weight.to(dt)).float()
        # a token sends at most min(k, count) of its choices here
        y = _HeldExperts.apply(xd, pos, gates, self.w_in, self.w_out, offs,
                               t * min(k, count))
        if sp.shared:
            y = y + shared
        _count_held(sizes)
        self.stats = {"counts": counts.detach(), "held": sizes.detach()}
        return y, balance

    @torch.no_grad()
    def update_bias(self) -> None:
        """DeepSeek-V3's loss-free balancing: ``b_i += gamma * sign(mean
        load - load_i)`` over the assignments this rank routed since the
        last update (every forward of the step), then the count starts
        again."""
        load = self.load.float()
        self.score_bias.add_(torch.sign(load.mean() - load),
                             alpha=self.spec.bias_rate)
        self.load.zero_()
